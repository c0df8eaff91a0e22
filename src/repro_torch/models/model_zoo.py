"""Uniform model interface: family dispatch.

`get_model(cfg)` returns a `ModelBundle` whose functions close over the
config, as the JAX package's does; `init` builds the module from a seed on
a device instead of returning a parameter tree. Only the dense family is
ported. The dry-run stand-ins (`input_specs`, `batch_logical_axes`,
`abstract_params`) come with `launch/*`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.models import dense
from repro_torch.models.config import ModelConfig

# family → the ROADMAP.md entry (Open items §1, item 11) that ports it
NOT_PORTED = {
    "vlm": "the vlm prefix-LM branch of models/dense.py",
    "moe": "models/moe.py",
    "encdec": "models/encdec.py",
    "xlstm": "models/xlstm.py",
    "hybrid": "models/zamba.py with models/mamba2.py",
}


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ModelConfig
    init: Callable          # (seed=0, device=None) -> model
    prefill: Callable       # (model, batch, max_len=0) -> (logits, cache)
    decode_step: Callable   # (model, cache, batch) -> (logits, cache)
    make_cache: Callable    # (batch, seq, device=None) -> cache


def get_model(cfg: ModelConfig) -> ModelBundle:
    if cfg.family != "dense":
        what = NOT_PORTED.get(cfg.family, f"family {cfg.family!r}")
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet; see ROADMAP.md, "
            f"Open items §1, item 11 ({what})")
    return ModelBundle(
        cfg=cfg,
        init=lambda seed=0, device=None: dense.DenseLM(cfg, seed=seed, device=device),
        prefill=lambda m, b, max_len=0: dense.prefill(m, b, max_len=max_len),
        decode_step=lambda m, c, b: dense.decode_step(m, c, b),
        make_cache=lambda batch, seq, device=None: dense.make_cache(cfg, batch, seq, device),
    )
