"""Fault-tolerant training loop: the port of `repro.train.trainer`.

The controller survives worker exceptions (restore the latest checkpoint
and continue, up to `max_restarts`), preemption (atomic async checkpoints
and deterministic data) and stragglers (a per-step wall-time watchdog with
EMA outlier detection), as the reference's does.

State is {"params": the model (an `nn.Module`, updated in place by the
train step), "opt": `AdamWState` keyed by parameter name, "err": the
compression error keyed as JAX's tree, or None}. Checkpoints go through
the port's `checkpoint.manager` in the reference's layout: the tree
{"params", "opt", "err"?} with JAX's parameter keys and pattern groups
stacked (`convert.stack_as_jax`), so the manifest keys are the reference's
(`opt/.step`, `opt/.m/<key>`, `opt/.v/<key>`, `params/<key>`, `err/<key>`)
and each package resumes the other's checkpoint. The checkpoint manager
refuses bfloat16 leaves (numpy has no such type without `ml_dtypes`, and
the reference's restore cannot read its own bfloat16 leaves), so the
`Trainer` checkpoints float32 configs; a bfloat16 model trains through
`make_train_step` directly.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import convert
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.tokens import DataConfig, PrefetchLoader, SyntheticTokens, stub_inputs
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model_zoo import ModelBundle, stub_shapes
from repro_torch.train import grad_compress, optimizer as opt
from repro_torch.train.train_step import make_train_step

log = logging.getLogger("repro_torch.trainer")


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    checkpoint_dir: str = "repro_ckpt"
    keep_checkpoints: int = 3
    log_every: int = 10
    compress_grads: bool = False
    max_restarts: int = 3
    straggler_ema: float = 0.9
    straggler_factor: float = 3.0   # step > factor × EMA ⇒ flagged


@dataclasses.dataclass
class StragglerWatchdog:
    """EMA step-time monitor. On a fleet this feeds the controller's
    replace/deschedule decision; here it records + logs flags."""

    ema: float = 0.0
    factor: float = 3.0
    alpha: float = 0.9
    warmup: int = 2  # the first steps build kernels and caches: never representative
    _seen: int = 0
    flagged: List[int] = dataclasses.field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        if self._seen < self.warmup:
            self._seen += 1
            self.ema = dt  # overwrite: last warmup step seeds the EMA
            return False
        is_straggler = dt > self.factor * self.ema
        if is_straggler:
            self.flagged.append(step)
            log.warning("straggler step %d: %.3fs vs EMA %.3fs", step, dt, self.ema)
        else:  # don't pollute the EMA with outliers
            self.ema = self.alpha * self.ema + (1 - self.alpha) * dt
        return is_straggler


class _Batches:
    """`SyntheticTokens`' batches with the model's stub frontend inputs
    beside them (`data.tokens.stub_inputs`)."""

    def __init__(self, data_cfg: DataConfig, shapes):
        self.tokens = SyntheticTokens(data_cfg)
        self.shapes = shapes

    def batch(self, step: int):
        return {**self.tokens.batch(step), **stub_inputs(self.tokens.cfg, step, self.shapes)}


class Trainer:
    """Runs `make_train_step` over `SyntheticTokens` on `device` (the card
    unless the caller asks for the CPU). A family whose stub frontend takes
    inputs beyond the tokens gets them from `data.tokens.stub_inputs`."""

    def __init__(self, model: ModelBundle, ocfg: opt.OptimizerConfig,
                 tcfg: TrainerConfig, data_cfg: DataConfig,
                 step_hook: Optional[Callable[[int], None]] = None,
                 device: DeviceLike = None):
        self.model = model
        self.ocfg = ocfg
        self.tcfg = tcfg
        self.data_cfg = data_cfg
        self.device = resolve_device(device)
        self.ckpt = CheckpointManager(tcfg.checkpoint_dir, keep=tcfg.keep_checkpoints)
        self.watchdog = StragglerWatchdog(factor=tcfg.straggler_factor,
                                          alpha=tcfg.straggler_ema)
        self.step_hook = step_hook  # fault-injection point for tests
        self._step_fn = make_train_step(model, ocfg, tcfg.compress_grads)
        self.history: List[Dict[str, float]] = []
        self.restarts = 0

    # -- state ----------------------------------------------------------------

    def init_state(self, seed: int = 0):
        module = self.model.init(seed=seed, device=self.device)
        params = dict(module.named_parameters())
        err = (grad_compress.init_error(convert.stack_as_jax(params, self.model.cfg))
               if self.tcfg.compress_grads else None)
        return {"params": module, "opt": opt.init(params), "err": err}

    def checkpoint_tree(self, state) -> Dict[str, Any]:
        """The state as the reference's checkpoint tree (JAX's keys, groups
        stacked)."""
        cfg = self.model.cfg
        params = {n: p.detach() for n, p in state["params"].named_parameters()}
        o = state["opt"]
        tree = {"params": convert.stack_as_jax(params, cfg),
                "opt": opt.AdamWState(step=o.step, m=convert.stack_as_jax(o.m, cfg),
                                      v=convert.stack_as_jax(o.v, cfg))}
        if state["err"] is not None:
            tree["err"] = state["err"]
        return tree

    def _save(self, step: int, state):
        self.ckpt.save_async(step, self.checkpoint_tree(state),
                             extras={"step": step, "data_seed": self.data_cfg.seed})

    def _restore(self, state):
        step = self.ckpt.latest()
        if step is None:
            return 0, state
        tree = self.ckpt.restore(self.checkpoint_tree(state), step)
        cfg = self.model.cfg
        params = dict(state["params"].named_parameters())
        o = state["opt"]
        with torch.no_grad():
            for got, into in ((tree["params"], params), (tree["opt"].m, o.m),
                              (tree["opt"].v, o.v)):
                for name, t in convert.unstack_from_jax(got, cfg, into).items():
                    into[name].copy_(t)
        out = {"params": state["params"],
               "opt": opt.AdamWState(step=tree["opt"].step, m=o.m, v=o.v),
               "err": tree.get("err", state["err"])}
        return step, out

    # -- loop -----------------------------------------------------------------

    def run(self, resume: bool = True) -> Dict[str, Any]:
        state = self.init_state()
        start = 0
        if resume and self.ckpt.latest() is not None:
            start, state = self._restore(state)
            log.info("resumed from step %d", start)

        source = _Batches(self.data_cfg, stub_shapes(self.model.cfg, self.data_cfg.seq_len))
        loader = PrefetchLoader(source, start_step=start)
        step = start
        try:
            while step < self.tcfg.total_steps:
                try:
                    step, state = self._run_span(loader, step, state)
                except KeyboardInterrupt:
                    raise
                except Exception as e:  # worker failure → restore & continue
                    self.restarts += 1
                    log.exception("step %d failed (%s); restart %d/%d", step, e,
                                  self.restarts, self.tcfg.max_restarts)
                    if self.restarts > self.tcfg.max_restarts:
                        raise
                    loader.close()
                    state = None     # the failed state goes before a new one is built
                    step, state = self._restore(self.init_state())
                    loader = PrefetchLoader(source, start_step=step)
        finally:
            loader.close()
            self.ckpt.wait()
        self._save(step, state)
        self.ckpt.wait()
        return {"state": state, "history": self.history,
                "stragglers": self.watchdog.flagged, "restarts": self.restarts,
                "final_step": step}

    def _run_span(self, loader, step: int, state):
        while step < self.tcfg.total_steps:
            got_step, batch = next(loader)
            if got_step != step:
                raise RuntimeError(f"the loader gave step {got_step}, expected {step}")
            t0 = time.perf_counter()
            if self.step_hook is not None:  # inside the timed+guarded region
                self.step_hook(step)
            module, opt_state, err, metrics = self._step_fn(
                state["params"], state["opt"], state["err"], batch)
            loss = float(metrics["loss"])  # waits for the device → true step time
            dt = time.perf_counter() - t0
            if not np.isfinite(loss):
                raise FloatingPointError(f"non-finite loss at step {step}")
            state = {"params": module, "opt": opt_state, "err": err}
            self.watchdog.observe(step, dt)
            self.history.append({"step": step, "loss": loss, "time": dt,
                                 "grad_norm": float(metrics["grad_norm"])})
            step += 1
            if step % self.tcfg.checkpoint_every == 0:
                self._save(step, state)
            if step % self.tcfg.log_every == 0:
                log.info("step %d loss %.4f (%.0f ms)", step, loss, dt * 1e3)
        return step, state
