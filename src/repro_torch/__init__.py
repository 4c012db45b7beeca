"""PyTorch/CUDA port of the serving stack of ``repro``.

The JAX package ``repro`` stays the reference; this package mirrors its
layout module by module (``repro_torch/<subpkg>/<module>.py`` for each
``repro/<subpkg>/<module>.py``) and imports neither JAX nor anything of
``repro``.  Its entry points run on a CUDA device unless the caller
passes ``device="cpu"``.
"""
