#!/usr/bin/env python
"""brlint CLI of the port: static analysis of captured steps and of the
threaded host stack (``batchreactor_tpu_torch/analysis/``).

  python -m batchreactor_tpu_torch.tools.brlint batchreactor_tpu_torch/ chip_smoke.py
  python -m batchreactor_tpu_torch.tools.brlint --tier C --device cpu
  python -m batchreactor_tpu_torch.tools.brlint --tier C --device cuda
  python -m batchreactor_tpu_torch.tools.brlint --tier D --device cpu
  python -m batchreactor_tpu_torch.tools.brlint --concurrency --json
  python batchreactor_tpu_torch/tools/brlint.py batchreactor_tpu_torch/

Exit codes: 0 = clean, 1 = findings, 2 = usage error, with ``--json``
exactly as without.

Tier A and the concurrency lint are stdlib-only AST scans and must run on
a host whose torch is missing or broken.  ``batchreactor_tpu_torch/
__init__.py`` imports torch, so this script, run by path, loads the
analysis subpackage through a lightweight namespace parent instead
(``python -m`` imports the real package first, which needs torch).  The
contract tier imports torch lazily, inside its engine.
"""

import os
import sys
import types

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# lightweight parent package: gives ``batchreactor_tpu_torch.analysis.*``
# (and, for the contract tier, the package's subpackages through their
# relative imports) an import path WITHOUT executing the package
# ``__init__``.  setdefault: a process that already imported the real
# package keeps it.
_pkg = types.ModuleType("batchreactor_tpu_torch")
_pkg.__path__ = [os.path.join(REPO, "batchreactor_tpu_torch")]
sys.modules.setdefault("batchreactor_tpu_torch", _pkg)

from batchreactor_tpu_torch.analysis.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
