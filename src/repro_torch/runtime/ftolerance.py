"""Fault tolerance: the resumable training loop, failure injection and
the straggler monitor (port of ``repro/runtime/ftolerance.py``).

A node failure kills the process; recovery is restart + restore the
latest checkpoint + resume the data stream at the saved step (the
pipeline is deterministic in (seed, step), so no data is skipped or
repeated). ``Trainer`` runs exactly that loop; tests inject failures
mid-run and hold the end state to an uninterrupted run's.
"""
from __future__ import annotations

import time


class StragglerMonitor:
    """EMA step-time tracker; flags steps slower than ``threshold`` x EMA
    (recorded in ``flagged``, the outlier kept out of the EMA)."""

    def __init__(self, alpha: float = 0.1, threshold: float = 2.0,
                 warmup: int = 5):
        self.alpha = alpha
        self.threshold = threshold
        self.warmup = warmup
        self.ema = None
        self.n = 0
        self.flagged: list[tuple[int, float, float]] = []

    def record(self, step: int, dt: float) -> bool:
        self.n += 1
        if self.ema is None:
            self.ema = dt
            return False
        is_straggler = (self.n > self.warmup
                        and dt > self.threshold * self.ema)
        if is_straggler:
            self.flagged.append((step, dt, self.ema))
        else:   # don't let the outlier poison the EMA
            self.ema = (1 - self.alpha) * self.ema + self.alpha * dt
        return is_straggler


class SimulatedFailure(RuntimeError):
    pass


class Trainer:
    """Checkpointed training loop with crash recovery.

    ``run()`` survives any number of SimulatedFailure crashes between
    checkpoints: each retry restores the latest checkpoint and replays the
    deterministic data stream from there. Unlike the reference, a pending
    asynchronous write is joined before the retry (the retry may write
    the same step's ``.tmp`` directory), so the retry resumes from the
    newest checkpoint begun before the failure. ``metrics_log`` holds each
    step's metrics as floats (a host read each step, as the reference's),
    ``step_times`` each step's host seconds (the metrics' read waits for
    the device), ``ckpt_log`` each checkpoint's bytes and seconds.

    Across ranks (a sharded state), every rank runs the same loop: an
    injected failure fires at the same step on each, each retry restores
    on each (``restore_shardings``: the state's placements, passed to
    ``ckpt.restore``), and a pending write is joined on rank 0 while the
    other ranks wait for it at the save handle's barrier.
    """

    def __init__(self, *, step_fn, init_state_fn, next_batch_fn, ckpt_dir,
                 ckpt_every: int = 10, keep_last: int = 3,
                 fail_at: set | None = None, async_ckpt: bool = False,
                 restore_shardings=None):
        self.step_fn = step_fn
        self.init_state_fn = init_state_fn
        self.next_batch_fn = next_batch_fn
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.keep_last = keep_last
        self.fail_at = fail_at or set()
        self.async_ckpt = async_ckpt
        self.restore_shardings = restore_shardings
        self.monitor = StragglerMonitor()
        self.metrics_log: list[dict] = []
        self.step_times: list[float] = []
        self.ckpt_log: list[dict] = []
        self.restarts = 0

    def _restore_or_init(self):
        from repro_torch.checkpoint import ckpt

        state = self.init_state_fn()
        if ckpt.latest_step(self.ckpt_dir) is not None:
            return ckpt.restore(state, self.ckpt_dir,
                                shardings=self.restore_shardings)
        return state, 0

    def run(self, total_steps: int, *, max_restarts: int = 10):
        from repro_torch.checkpoint import ckpt

        attempts = 0
        pending = None
        while True:
            try:
                state, start = self._restore_or_init()
                for step in range(start, total_steps):
                    if step in self.fail_at:
                        self.fail_at.discard(step)
                        raise SimulatedFailure(
                            f"injected failure @ step {step}")
                    t0 = time.perf_counter()
                    batch = self.next_batch_fn(step)
                    state, metrics = self.step_fn(state, batch)
                    row = {"step": step,
                           **{k: float(v) for k, v in metrics.items()}}
                    dt = time.perf_counter() - t0
                    self.monitor.record(step, dt)
                    self.step_times.append(dt)
                    self.metrics_log.append(row)
                    if (step + 1) % self.ckpt_every == 0:
                        if pending is not None:
                            pending.join()
                        pending = ckpt.save(state, self.ckpt_dir, step + 1,
                                            keep_last=self.keep_last,
                                            async_=self.async_ckpt,
                                            log=self.ckpt_log)
                if pending is not None:
                    pending.join()
                ckpt.save(state, self.ckpt_dir, total_steps,
                          keep_last=self.keep_last, log=self.ckpt_log)
                return state
            except SimulatedFailure:
                # a simulated crash leaves the writer thread alive: let it
                # publish before the retry, which may write the same step
                if pending is not None:
                    pending.join()
                    pending = None
                attempts += 1
                self.restarts += 1
                if attempts > max_restarts:
                    raise
