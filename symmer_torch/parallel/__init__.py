"""Host parallel execution: ``process``.

The counterpart of ``symmer_tpu/parallel/__init__.py``'s ``ProcessHandler``
(the reference's ``process_handler.py``): ``@process.parallelize`` turns a
``f(item, shared)`` function into ``f(iterable, shared)``.  Methods:

  - 'vectorised' (default): a plain host loop -- the packed kernels make
    per-item work so cheap that process pools lose;
  - 'mp': a fork-based pool of processes (chunked, order-preserving) for
    coarse host-side work;
  - 'single_thread': alias of the loop, for parity with the reference.

'mp' forks, so that locally defined functions need no pickling, as in the
reference.  A forked child cannot use CUDA once the parent has initialised
it ("Cannot re-initialize CUDA in forked subprocess"), so when the parent
holds a CUDA context and the device path may run on the card
(``config.backend`` not 'host', ``config.device`` CUDA) the pool raises
before it forks; a child's exception is sent back and raised in the parent.
The multi-GPU layer (``mesh``, ``distributed``) is not ported yet.
"""
from __future__ import annotations

import os
import traceback
from typing import Callable, Iterable


def _children_would_need_cuda() -> bool:
    import torch

    from ..config import config

    return (torch.cuda.is_initialized() and config.backend != "host"
            and config.device.type == "cuda")


class ProcessHandler:
    method = "vectorised"
    verbose = False

    def __init__(self):
        self.n_logical_cores = os.cpu_count()

    def _process_loop(self, func, iterable, shared):
        return [func(i, shared) for i in iterable]

    def prepare_chunks(self, iterable):
        """Split an iterable into at most ``n_logical_cores`` chunks
        (API parity with reference process_handler.py:25-33)."""
        items = list(iterable)
        if not items:
            return
        self.n_chunks = min(len(items), self.n_logical_cores)
        chunk_size = -(-len(items) // self.n_chunks)
        for i in range(0, len(items), chunk_size):
            yield items[i : i + chunk_size]

    def _process_mp(self, func, iterable, shared):
        """Fork-based chunked pool with order restoration."""
        import multiprocessing as mp

        items = list(iterable)
        if not items:
            return []
        if _children_would_need_cuda():
            raise RuntimeError(
                "process.method = 'mp' forks, and a forked child cannot use the CUDA "
                "context this process holds; use process.method = 'vectorised', or "
                "config.backend = 'host' for host-only work"
            )
        ctx = mp.get_context("fork")
        chunks = list(self.prepare_chunks(items))
        queue = ctx.Queue(len(chunks))

        def worker(chunk, order):
            try:
                queue.put((order, True, [func(i, shared) for i in chunk]))
            except Exception:  # the parent raises it (else it would wait forever)
                queue.put((order, False, traceback.format_exc()))

        procs = []
        for order, chunk in enumerate(chunks):
            p = ctx.Process(target=worker, args=(chunk, order))
            p.start()
            procs.append(p)
        data = [queue.get() for _ in range(len(chunks))]
        for p in procs:
            p.join()
        failed = [msg for _, ok, msg in data if not ok]
        if failed:
            raise RuntimeError(f"process: a worker failed: {failed[0]}")
        return [a for _, _, b in sorted(data, key=lambda t: t[0]) for a in b]

    def parallelize(self, func: Callable):
        def wrapper(iterable: Iterable, shared):
            if self.method in ("vectorised", "single_thread"):
                return self._process_loop(func, iterable, shared)
            elif self.method == "mp":
                return self._process_mp(func, iterable, shared)
            raise ValueError(
                f"Invalid processing method {self.method}, "
                "must be vectorised, mp or single_thread."
            )

        return wrapper


process = ProcessHandler()
