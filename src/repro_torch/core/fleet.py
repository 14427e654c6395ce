"""Thread-per-device fleet driver: concurrent workers, epoch barriers. The
port's copy of the JAX package's ``core/fleet.py`` (it has no framework
in it).

:class:`FleetDriver` owns one long-lived worker thread per device. The
driver (main) thread dispatches one callable per device and blocks until
every worker has finished — ``map_epoch`` is the barrier. Between a
dispatch and its barrier, worker *i* exclusively owns device *i*'s
executor; the driver thread may only touch executor state while all
workers are parked. That is the **epoch-barrier rule** (see
CONTRIBUTING): shared placement state — the plan, the rebalancer's views,
another device's executor — is mutated only between barriers, on the
driver thread, so per-device decision sequences under nominal accounting
are bitwise-identical to the sequential device-at-a-time loop the driver
replaced (the differential suite is the contract).

Lock order: the driver has exactly one lock, the condition backing the
dispatch/completion handshake. Workers never take another lock while
holding it, and the only calls made under it are in-memory bookkeeping —
the epoch body (``run_epoch`` / ``run``) executes *outside* the critical
section. ``close`` joins the workers with the condition released: a join
while holding it would deadlock, since a worker needs the condition to
publish its completion (that shape is what RPL042 tables ``join`` for).
"""
from __future__ import annotations

import threading
from typing import Any, Callable, List, Optional, Sequence


class FleetDriver:
    """One worker thread per device, synchronized at epoch boundaries."""

    def __init__(self, n_workers: int, name: str = "fleet") -> None:
        if n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {n_workers}")
        self._cv = threading.Condition()
        # All driver state below is guarded by ``_cv``'s lock. A non-None
        # command slot means that worker's epoch body is dispatched or
        # running; the worker clears it when it publishes its result.
        self._commands: List[Optional[Callable[[], Any]]] = [None] * n_workers
        self._results: List[Any] = [None] * n_workers
        self._errors: List[Optional[BaseException]] = [None] * n_workers
        self._done = 0
        self._closing = False
        self._threads = [
            threading.Thread(
                target=self._worker, args=(i,), name=f"{name}-dev{i}", daemon=True
            )
            for i in range(n_workers)
        ]
        for th in self._threads:
            th.start()

    def __enter__(self) -> "FleetDriver":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    @property
    def n_workers(self) -> int:
        return len(self._threads)

    def _worker(self, idx: int) -> None:
        while True:
            with self._cv:
                while self._commands[idx] is None and not self._closing:
                    self._cv.wait()
                fn = self._commands[idx]
                if fn is None:
                    return  # closing, nothing dispatched
            # Epoch body runs OUTSIDE the critical section: this worker
            # exclusively owns its device's executor until the barrier.
            result: Any = None
            error: Optional[BaseException] = None
            try:
                result = fn()
            except BaseException as exc:  # noqa: BLE001 — published, re-raised by the driver
                error = exc
            with self._cv:
                self._commands[idx] = None
                self._results[idx] = result
                self._errors[idx] = error
                self._done += 1
                self._cv.notify_all()

    def map_epoch(self, fns: Sequence[Callable[[], Any]]) -> List[Any]:
        """Dispatch one callable per worker and wait for all of them (the
        epoch barrier). Results come back in worker order. If any worker
        raised, the lowest-indexed worker's exception is re-raised here —
        deterministic regardless of completion order — after every worker
        has parked (no epoch body is left running)."""
        n = len(self._threads)
        if len(fns) != n:
            raise ValueError(f"expected {n} callables, got {len(fns)}")
        with self._cv:
            if self._closing:
                raise RuntimeError("FleetDriver is closed")
            if self._done or any(c is not None for c in self._commands):
                raise RuntimeError("map_epoch called with an epoch in flight")
            self._results = [None] * n
            self._errors = [None] * n
            for i, fn in enumerate(fns):
                self._commands[i] = fn
            self._cv.notify_all()
            while self._done < n:
                self._cv.wait()
            self._done = 0
            results = list(self._results)
            errors = list(self._errors)
        for err in errors:
            if err is not None:
                raise err
        return results

    def close(self) -> None:
        """Stop and join every worker. Idempotent. The join happens with
        the condition released — a worker needs it to exit its wait."""
        with self._cv:
            self._closing = True
            self._cv.notify_all()
        for th in self._threads:
            th.join()
