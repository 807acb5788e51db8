"""Pre-flight lint for a serialized Symbol graph (no binding, nothing
run; counterpart of the reference's ``tools/graph_lint.py``).

A launcher for ``python -m mxnet_tpu_torch.analysis`` — see
``analysis/cli.py`` for the flags and ``analysis.list_passes()`` for the
pass/rule catalog::

    python -m mxnet_tpu_torch.tools.graph_lint model-symbol.json \\
        --shape data=1,3,224,224
    python -m mxnet_tpu_torch.tools.graph_lint --list-rules
"""
import sys

from ..analysis.cli import main

if __name__ == "__main__":
    sys.exit(main())
