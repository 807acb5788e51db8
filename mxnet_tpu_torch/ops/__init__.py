"""Operators of the port: attention dispatch (``attention.py``), flash and
paged decode attention (``flash_attention.py``), the optimizer updates
(``optimizer_ops.py``) and the build of the CUDA kernels
(``_kernels.py``). The operator registry belongs to a later slice. (The
function ``flash_attention`` is not re-exported here: the name is the
submodule's.)"""
from .attention import fused_attention, plain_attention  # noqa: F401
from .flash_attention import (decode_attention,  # noqa: F401
                              flash_attention_with_lse,
                              flash_decode_attention)
