"""Launcher for the port's serving-contract analyzer.

    PYTHONPATH=src python -m repro_torch.launch.analyze --strict \
        --report analysis_report.json

Thin wrapper over ``python -m repro_torch.analysis`` (same flags) so the
analyzer sits next to the serve/train entry points; the rule table is
in README.md.
"""

from __future__ import annotations

import sys

from repro_torch.analysis.__main__ import main

if __name__ == "__main__":
    sys.exit(main())
