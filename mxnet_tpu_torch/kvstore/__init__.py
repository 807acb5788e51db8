"""``mxnet_tpu_torch.kvstore`` — the parameter-server plane's framing.

``ps_server.py`` holds the wire framing that the serve plane shares with
the parameter server (``_pack_arrays``, ``_recv_msg``, ``_send_msg``);
the key-value stores, the parameter server and elastic membership belong
to the distributed slice of the port (queue item A14).
"""
