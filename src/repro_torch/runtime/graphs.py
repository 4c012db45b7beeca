"""One CUDA graph per serving work unit.

PyTorch counterpart of the reference's one compiled program per work
unit (``jax.jit`` of the chunk, span and verify steps and of the
copy-on-write copy, the KV cache donated; ``compile_counts``).  A
`WorkUnit` owns a body, the static device buffers of its operands and
outputs and, on a CUDA device, one ``torch.cuda.CUDAGraph``.  The body
is a function of device tensors that updates the server's state in
place (the pool, the current tokens, the output buffer, the n-gram
table) and returns its outputs.

A call (`run`) takes the scheduler's operands as numpy arrays:

* they are copied into pinned host staging and from there, with
  ``non_blocking=True`` on the current stream, into the unit's static
  device buffers, outside the graph (the staging is not written again
  until an event says its copies are done);
* the first call runs the body eagerly on the unit's side stream: it is
  a real step, and it loads the lazily loaded CUDA modules and cuBLAS
  workspaces before any capture;
* the second call captures the body into the graph, in the graph
  memory pool the server's units share (they never run at once), and
  replays it once; every later call replays it.  No step runs twice
  and none is skipped.  A capture that fails raises: nothing falls
  back to running eagerly;
* the body's outputs are copied into static output buffers inside the
  captured body; the caller reads them after the dispatch, before the
  next call of the unit overwrites them.

The kernel wrappers count their launches in Python when they are
called, which a replay does not do: the launches counted while the
body was captured (by kernel and by body) are added to the kernels'
counts at every later replay, so the counts still say how often each
kernel ran.

A tensor-parallel server's body computes every shard of the mesh
(models/transformer.py).  Where the mesh lays its positions on one
physical device (a spread mesh), that is one stream and the unit is
still one CUDA graph, its operands staged once.  ``devices`` names the
distinct physical devices a body runs on: over more than one the unit
runs its body eagerly at every call (no capture across devices;
`captures` stays 0), its operands staged on the first device and copied
once to each other by the forward (models/common.replicate).

On the CPU the unit runs its body eagerly through the same static
buffers.  On either device `programs` is the number of distinct
operand signatures (shapes and dtypes) the unit has taken: 0 before its
first call, then 1.  A call with another signature raises; the unit
never captures twice.  `_eager` runs one call eagerly whatever the
device (for tests, and to hold replays against eager calls).
"""

from __future__ import annotations

import gc
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch


class WorkUnit:
    """One work unit of a server: its body, static buffers and graph.

    `counted` are kernel wrappers with ``launches`` and
    ``body_launches`` counts (kernels/paged_attention.KERNELS)."""

    def __init__(self, name: str, body: Callable[..., Tuple], device, *,
                 pool=None, counted: Sequence = (),
                 devices: Optional[Sequence] = None):
        self.name = name
        self._body = body
        self.device = torch.device(device)
        # one graph captures a body on one physical device only
        self.capturable = (self.device.type == "cuda"
                           and len({torch.device(d) for d in
                                    (devices or [device])}) == 1)
        self._pool = pool
        self._counted = tuple(counted)
        self._signature: Optional[Tuple] = None
        self._inputs: Tuple[torch.Tensor, ...] = ()
        self._staging: Tuple[torch.Tensor, ...] = ()
        self._staged: Optional[torch.cuda.Event] = None
        self._outputs: Optional[Tuple[torch.Tensor, ...]] = None
        self._stream = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        # launches of one replay, {kernel name: (all, {body: launches})}
        self.replay_launches: Dict[str, Tuple[int, Dict[str, int]]] = {}
        self.calls = 0
        # graphs captured, counted at each capture: 1 from the second
        # call on a CUDA device, and never more
        self.captures = 0

    @property
    def programs(self) -> int:
        """Operand signatures taken: 0 before the first call, then 1 (a
        second signature is refused by `_stage`, not counted)."""
        return int(self._signature is not None)

    # -- operands ----------------------------------------------------------
    def _stage(self, operands: Sequence[np.ndarray]) -> None:
        """Copy the operands into the static device buffers (through
        pinned staging on CUDA), fixing the signature at the first
        call."""
        arrays = [np.ascontiguousarray(a) for a in operands]
        sig = tuple((a.shape, a.dtype.str) for a in arrays)
        cuda = self.device.type == "cuda"
        if self._signature is None:
            host = [torch.from_numpy(a) for a in arrays]
            self._inputs = tuple(torch.empty(h.shape, dtype=h.dtype,
                                             device=self.device)
                                 for h in host)
            if cuda:
                self._staging = tuple(torch.empty(h.shape, dtype=h.dtype,
                                                  pin_memory=True)
                                      for h in host)
            self._signature = sig
        elif sig != self._signature:
            raise ValueError(
                f"work unit {self.name}: operands {sig} are not those of "
                f"its program {self._signature}; a unit never captures "
                "twice")
        if not cuda:
            for d, a in zip(self._inputs, arrays):
                d.copy_(torch.from_numpy(a))
            return
        if self._staged is not None and not self._staged.query():
            self._staged.synchronize()
        for h, a in zip(self._staging, arrays):
            h.numpy()[...] = a
        for d, h in zip(self._inputs, self._staging):
            d.copy_(h, non_blocking=True)
        self._staged = torch.cuda.Event()
        self._staged.record()

    def _step(self) -> None:
        """The body on the static inputs, its outputs copied into the
        static outputs (allocated at the first, eager, call)."""
        outs = self._body(*self._inputs)
        if self._outputs is None:
            self._outputs = tuple(torch.empty_like(o) for o in outs)
        for s, o in zip(self._outputs, outs):
            s.copy_(o)

    # -- launch counts -----------------------------------------------------
    def _launch_counts(self) -> Dict[str, Tuple[int, Dict[str, int]]]:
        return {fn.__name__: (fn.launches, dict(fn.body_launches))
                for fn in self._counted}

    def _count_replay(self) -> None:
        for fn in self._counted:
            n, by_body = self.replay_launches[fn.__name__]
            fn.launches += n
            for b, k in by_body.items():
                fn.body_launches[b] += k

    # -- calls -------------------------------------------------------------
    def _capture(self) -> None:
        """Capture the body (the wrappers count its launches as they are
        recorded), then replay it once: the capture itself runs
        nothing.

        A server is a reference cycle (its units' bodies are its bound
        methods), so a dead one is freed only by the garbage collector,
        with its graphs, pinned staging and events.  Freed inside a
        capture, they invalidate it.  So the collector runs before the
        capture and is off while it lasts."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        before = self._launch_counts()
        graph = torch.cuda.CUDAGraph()
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._pool,
                                  stream=self._stream):
                self._step()
        finally:
            if collecting:
                gc.enable()
        after = self._launch_counts()
        self.replay_launches = {
            k: (after[k][0] - before[k][0],
                {b: after[k][1][b] - before[k][1].get(b, 0)
                 for b in after[k][1]})
            for k in after}
        self.graph = graph
        self.captures += 1
        graph.replay()

    def run(self, *operands: np.ndarray) -> Tuple[torch.Tensor, ...]:
        """One call of the unit: stage the operands, then run, capture or
        replay.  Returns the static outputs."""
        if not self.capturable:
            return self._eager(*operands)
        self._stage(operands)
        if self.graph is not None:
            self.graph.replay()
            self._count_replay()
        elif self.calls == 0:
            self._stream = torch.cuda.Stream(self.device)
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self._stream):
                self._step()
            torch.cuda.current_stream(self.device).wait_stream(self._stream)
        else:
            self._capture()
        self.calls += 1
        return self._outputs

    def _eager(self, *operands: np.ndarray) -> Tuple[torch.Tensor, ...]:
        """One call run eagerly on the current stream, through the same
        static buffers, whatever the device."""
        self._stage(operands)
        self._step()
        self.calls += 1
        return self._outputs
