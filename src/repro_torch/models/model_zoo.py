"""Uniform model interface: family dispatch.

`get_model(cfg)` returns a `ModelBundle` whose functions close over the
config, as the JAX package's does; `init` builds the family's module from a
seed on a device instead of returning a parameter tree. Every family of
`configs/` serves: dense and vlm (`models/dense.py`), moe, encdec, xlstm
and hybrid (Zamba2). The frontends are stubs, as in the JAX package: a
paligemma prefill takes `img_embed` (B, n_img_tokens, VISION_FEAT), a
seamless one `frames` (B, S // audio_downsample, AUDIO_FEAT), and so does
a train batch, beside `tokens` and `targets` (`stub_shapes`).

The dry-run's stand-ins allocate nothing: `ModelBundle.abstract_params`
builds the module on the meta device and returns its parameters with their
logical axes (`layers.param_axes`), `abstract_cache` does the same for a
cache, and `input_specs` / `batch_logical_axes` give every input of an
(arch × shape) cell as meta tensors of the reference's shapes and dtypes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.models import dense, encdec, moe, xlstm, zamba
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.models.layers import param_axes

VISION_FEAT = dense.VISION_FEAT
AUDIO_FEAT = encdec.AUDIO_FEAT


def family_module(cfg: ModelConfig):
    return {
        "dense": dense, "vlm": dense,
        "moe": moe,
        "encdec": encdec,
        "xlstm": xlstm,
        "hybrid": zamba,
    }[cfg.family]


def k7_prefill_launches(cfg: ModelConfig) -> int:
    """K7 launches of one prefill on the card. `models.attention` sends K7
    every self-attention over the whole sequence: each dense and MoE layer,
    the enc-dec's encoder and decoder self-attention, Zamba2's shared block
    once a group. Paligemma's prefix mask (the plain softmax, as in JAX) and
    the recurrent xLSTM launch none; decode launches none."""
    return {"dense": cfg.n_layers, "moe": cfg.n_layers,
            "encdec": cfg.n_enc_layers + cfg.n_layers, "vlm": 0,
            "hybrid": cfg.n_layers // (cfg.attn_every or cfg.n_layers),
            "xlstm": 0}[cfg.family]


def k7_train_launches(cfg: ModelConfig) -> int:
    """K7 forward launches of one train step (`loss` and its gradient) on
    the card: each launch of the prefill, once more for each one inside a
    remat unit when `cfg.remat` is set, since the backward re-runs the
    unit's forward. The dense remainder layers lie outside the units. The
    backward kernel's launches are `k7_backward_launches`."""
    n = k7_prefill_launches(cfg)
    if not cfg.remat:
        return n
    if cfg.family == "dense":
        pat, n_groups, _rem = dense.layer_pattern(cfg)
        return n + n_groups * len(pat)
    return 2 * n


def k7_backward_launches(cfg: ModelConfig) -> int:
    """K7 backward launches of one train step on the card: one for each
    attention call in the loss, remat or not (a recomputed forward is
    differentiated once), so the prefill's count."""
    return k7_prefill_launches(cfg)


def stub_shapes(cfg: ModelConfig, seq_len: int) -> Dict[str, Tuple[int, ...]]:
    """The stub frontend's inputs a train or prefill batch of `seq_len`
    tokens brings, by name, each example's shape (float32)."""
    if cfg.family == "vlm":
        return {"img_embed": (cfg.n_img_tokens, VISION_FEAT)}
    if cfg.family == "encdec":
        return {"frames": (max(seq_len // cfg.audio_downsample, 1), AUDIO_FEAT)}
    return {}


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ModelConfig
    init: Callable          # (seed=0, device=None) -> model
    loss: Callable          # (model, batch) -> scalar
    prefill: Callable       # (model, batch, max_len=0) -> (logits, cache)
    decode_step: Callable   # (model, cache, batch) -> (logits, cache)
    make_cache: Callable    # (batch, seq, device=None) -> cache
    cache_axes: Callable    # () -> logical axes of the cache, leaf for leaf

    def abstract_params(self) -> Tuple[Dict[str, torch.Tensor], Dict[str, tuple]]:
        """({parameter name: meta tensor}, {parameter name: logical axes}),
        from the module built on the meta device: no allocation."""
        module = self.init(seed=0, device="meta")
        return ({n: p.detach() for n, p in module.named_parameters()},
                param_axes(module))

    def abstract_cache(self, batch: int, seq: int) -> Tuple[Any, Any]:
        """(the cache of `make_cache` on the meta device, its logical axes)."""
        return self.make_cache(batch, seq, device="meta"), self.cache_axes()


def get_model(cfg: ModelConfig) -> ModelBundle:
    fam = family_module(cfg)
    return ModelBundle(
        cfg=cfg,
        init=lambda seed=0, device=None: fam.init(cfg, seed=seed, device=device),
        loss=lambda m, b: fam.loss(m, b),
        prefill=lambda m, b, max_len=0: fam.prefill(m, b, max_len=max_len),
        decode_step=lambda m, c, b: fam.decode_step(m, c, b),
        make_cache=lambda batch, seq, device=None: fam.make_cache(cfg, batch, seq, device),
        cache_axes=lambda: fam.cache_axes(cfg),
    )


# ---------------------------------------------------------------------------
# input specs (dry-run stand-ins)
# ---------------------------------------------------------------------------


def batch_logical_axes(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, tuple]:
    if shape.mode in ("train", "prefill"):
        ax: Dict[str, tuple] = {"tokens": ("batch", None)}
        if shape.mode == "train":
            ax["targets"] = ("batch", None)
        if cfg.family == "vlm":
            ax["img_embed"] = ("batch", None, None)
        if cfg.family == "encdec":
            ax["frames"] = ("batch", None, None)
        return ax
    return {"token": ("batch",)}


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """Meta-tensor stand-ins for one (arch × shape) cell's inputs: a train
    or prefill batch, or a decode step's one new token a sequence."""
    b, s = shape.global_batch, shape.seq_len

    def meta(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.mode in ("train", "prefill"):
        batch = {"tokens": meta((b, s), torch.int32)}
        if shape.mode == "train":
            batch["targets"] = meta((b, s), torch.int32)
        for name, shp in stub_shapes(cfg, s).items():
            batch[name] = meta((b,) + shp, torch.float32)
        return batch
    return {"token": meta((b,), torch.int32)}
