"""``mxnet_tpu_torch.serve`` — autoregressive decode serving.

This slice of the port holds the paged-KV decode engine and its
continuous-batching scheduler (``decode.py``), the page pool
(``kvcache.py``) and the typed serving errors (``engine.py``). The batch
inference engine, the wire server and client, and the fleet belong to a
later slice.

Typical use::

    from mxnet_tpu_torch.models import transformer_lm
    from mxnet_tpu_torch.serve import DecodeEngine, DecodeScheduler

    lm = transformer_lm()
    lm.initialize()                             # on cuda:0
    engine = DecodeEngine(lm, slots=8, page_size=16, num_pages=1025)
    engine.warmup()
    sched = DecodeScheduler(engine)
    tokens = list(sched.generate(prompt, max_new_tokens=16))
    sched.close()
"""
from .decode import (DecodeEngine, DecodeScheduler,  # noqa: F401
                     StreamHandle, default_decode_buckets)
from .engine import (DeadlineExceeded, Draining,  # noqa: F401
                     RequestRejected, ServeError)
from .kvcache import PageLeakError, PagePool, PagesExhausted  # noqa: F401

__all__ = ["DecodeEngine", "DecodeScheduler", "StreamHandle",
           "default_decode_buckets", "ServeError", "RequestRejected",
           "DeadlineExceeded", "Draining", "PagePool", "PageLeakError",
           "PagesExhausted"]
