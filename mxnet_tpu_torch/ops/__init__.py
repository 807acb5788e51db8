"""Operators of the port.

Importing this package registers every ported op family in the
reference's order (``registry.py``; the analog of the reference's static
op registrations): elementwise, reductions, matrix, indexing, creation,
ordering, neural-net, sequence, the fused RNN, optimizer updates, random
sampling and densities, CTC, the image ops, the contrib ops (detection,
deformable convolution, SyncBatchNorm, ...) and the int8 quantization
ops; beside them the control-flow functions (``control_flow.py``),
attention dispatch
(``attention.py``), flash and paged decode attention
(``flash_attention.py``) and the build of the CUDA kernels
(``_kernels.py``). (The function ``flash_attention`` is not re-exported
here: the name is the submodule's.)
"""
from . import registry  # noqa: F401
from .registry import (alias, coerce_kwargs, get_op, has_op,  # noqa: F401
                       list_ops, register)

from . import elemwise  # noqa: F401,E402
from . import reduce  # noqa: F401,E402
from . import matrix  # noqa: F401,E402
from . import indexing  # noqa: F401,E402
from . import init_ops  # noqa: F401,E402
from . import ordering  # noqa: F401,E402
from . import nn  # noqa: F401,E402
from . import sequence  # noqa: F401,E402
from . import rnn  # noqa: F401,E402
from . import optimizer_ops  # noqa: F401,E402
from . import control_flow  # noqa: F401,E402
from . import random_ops  # noqa: F401,E402
from . import loss_ops  # noqa: F401,E402
from . import image_ops  # noqa: F401,E402
from . import contrib  # noqa: F401,E402
from . import quantization  # noqa: F401,E402

from .attention import fused_attention, plain_attention  # noqa: F401,E402
from .flash_attention import (decode_attention,  # noqa: F401,E402
                              flash_attention_with_lse,
                              flash_decode_attention)
