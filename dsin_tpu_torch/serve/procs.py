"""Where the serve stack's child processes come from.

`process_context()` is the multiprocessing context of the service's
entropy-pool children and the front door's replicas: a fork server, a fresh
interpreter that never initialises CUDA and imports `FORKSERVER_PRELOAD`
once. A child is then a fork of it and starts without importing torch again
(about 5 s on an H100 host, most of a spawned child's start); it is never a
fork of the caller, which may hold a CUDA context. The children are the
fork server's, not the caller's.

The environment is a snapshot: the fork server is started by the first pool
or router of the process and keeps the environment the process had then,
and every later child inherits that one. An environment variable set after
the first start is not seen by a later replica or pool child (under
`spawn` each child took the caller's environment at its own start).
"""

from __future__ import annotations

import multiprocessing

#: what the fork server imports once, for every child it forks: the service
#: and everything it reaches (torch, the codec, the router)
FORKSERVER_PRELOAD = ["dsin_tpu_torch.serve.service"]


def process_context():
    """The fork-server context the serve stack starts its children from."""
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(FORKSERVER_PRELOAD)
    return ctx
