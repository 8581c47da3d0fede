"""Restarting training supervisor: the reference's
``repro/runtime/supervisor.py``.

  * periodic atomic checkpoints (the asynchronous writer of
    ``checkpoint.ckpt``), and a final ``ckpt.wait()``;
  * bounded-retry restart from the newest checkpoint on a failed step (any
    exception; failures can be injected at any step for tests), the data
    stream re-seated at the checkpoint's state;
  * a non-finite loss is a failed step;
  * a straggler flag for a step that takes more than ``straggler_factor``
    times the rolling median (recorded in the report).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np

from repro_torch.checkpoint.ckpt import Checkpointer


@dataclass
class SupervisorConfig:
    ckpt_every: int = 50
    max_restarts: int = 3
    straggler_factor: float = 3.0
    heartbeat_every: int = 1


@dataclass
class SupervisorReport:
    steps_run: int = 0
    restarts: int = 0
    straggler_events: List[int] = field(default_factory=list)
    losses: List[float] = field(default_factory=list)
    heartbeats: List[float] = field(default_factory=list)


class Supervisor:
    def __init__(self, step_fn: Callable, ckpt: Checkpointer,
                 cfg: SupervisorConfig = SupervisorConfig(),
                 failure_injector: Optional[Callable[[int], None]] = None,
                 straggler_injector: Optional[Callable[[int], float]] = None):
        self.step_fn = step_fn
        self.ckpt = ckpt
        self.cfg = cfg
        self.failure_injector = failure_injector
        self.straggler_injector = straggler_injector
        self.report = SupervisorReport()

    def run(self, params, opt_state, data, total_steps: int,
            start_step: int = 0):
        """Run to ``total_steps`` with restart-on-failure. Returns
        (params, opt_state, report)."""
        step = start_step
        restarts = 0
        times: List[float] = []
        while step < total_steps:
            try:
                t0 = time.time()
                if self.failure_injector is not None:
                    self.failure_injector(step)
                if self.straggler_injector is not None:
                    time.sleep(self.straggler_injector(step))
                batch = data.next_batch()
                params, opt_state, metrics = self.step_fn(
                    params, opt_state, batch, step)
                loss = float(metrics["loss"])       # waits for the step
                if not np.isfinite(loss):
                    raise FloatingPointError(f"non-finite loss at step {step}")
                dt = time.time() - t0
                times.append(dt)
                med = float(np.median(times[-20:]))
                if len(times) > 5 and dt > self.cfg.straggler_factor * med:
                    self.report.straggler_events.append(step)
                self.report.losses.append(loss)
                self.report.heartbeats.append(time.time())
                self.report.steps_run += 1
                step += 1
                if step % self.cfg.ckpt_every == 0 or step == total_steps:
                    self.ckpt.save(step, params, opt_state,
                                   data.state.to_dict())
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception:
                restarts += 1
                self.report.restarts = restarts
                if restarts > self.cfg.max_restarts:
                    raise
                # restore from the newest good checkpoint (or start over)
                latest = self.ckpt.latest_step()
                if latest is not None:
                    step, params, opt_state, dstate = self.ckpt.restore(
                        params_template=params, opt_template=opt_state)
                    data.state.seed = dstate["seed"]
                    data.state.step = dstate["step"]
                else:
                    step = start_step
        self.ckpt.wait()
        return params, opt_state, self.report
