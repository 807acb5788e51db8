"""``mxnet_tpu_torch.kvstore`` (``mx.kv``): the key-value stores and
distributed training (counterpart of ``mxnet_tpu/kvstore``).

- ``kvstore.py`` — :class:`KVStore`, the one-process stores, and
  :func:`create`, which takes every name the reference's does;
- ``dist.py`` — ``DistKVStore``: ``dist_sync`` over a
  ``torch.distributed`` process group, ``dist_async`` over the parameter
  server, elastic ``dist_sync`` over the PS wire;
- ``compression.py`` — 2-bit gradient compression with error feedback;
- ``ps_server.py`` / ``ps_client.py`` — the parameter server and its
  client, on the length-prefixed wire the serve plane shares;
- ``elastic.py`` — membership, generation-scoped reduces and epoch
  rendezvous, the push write-ahead log, the worker session.

``native.ps_server_binary()`` builds the reference's C++ server
(``native/ps/ps_server.cc``) unchanged, and ``tools/launch.py`` starts
workers and a server.
"""
from .kvstore import KVStore, create  # noqa: F401

__all__ = ["KVStore", "create"]
