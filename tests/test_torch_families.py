"""The port's enc-dec, vlm (paligemma's prefix-LM), Zamba2 and xLSTM serving
paths against the JAX package on the CPU, in float32 at `reduced` size
with weights carried by `convert.params_from_jax` (the norm scales, QKV
biases and Mamba2's A_log/D/dt_bias seeded): prefill logits, every cache
leaf, and 3 greedy decode steps (logits and caches), each within 1e-4
rtol/atol; the uncached forward (the enc-dec's encoder).

The xLSTM states are the one exception: each state leaf is held within
1e-4 of its largest |value|. They are float32 sums of exponentially gated
outer products, and the few-ulp difference of two op orders grows with
depth: measured on a CPU at 7 layers, the C state's largest gap to JAX is
1e-6 of its scale after block 0 and 1.3e-5 after block 4 (2.2e-4 at
values up to 17, so single entries near 0 differ by 3e-3 relatively),
while the logits stay within 4.6e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import encdec as jencdec
from repro.models import model_zoo as jzoo
from repro.models.config import reduced as jreduced
from repro_torch.configs import get_arch
from repro_torch.models import dense, encdec, model_zoo
from repro_torch.models.config import reduced

from _torch_parity import (assert_cache_close, assert_close, np_, port_cache_from_jax,
                           randomize_constants, to_torch_model)

TOL = 1e-4      # as tests/test_torch_dense.py
BATCH, PROMPT, DECODE = 2, 40, 3

# reduced(): d 128, 4 heads of 32, vocab 512. xlstm at 7 layers is one
# 6-block group (5 mLSTM + 1 sLSTM) and one remainder mLSTM block (at
# reduced()'s 4 layers it would have no sLSTM); zamba2 at 4 layers is 2
# groups of 2 Mamba2 blocks, each followed by the shared block; paligemma
# has 16 image tokens, seamless 2 encoder layers over 10 frames.
CASES = {
    "seamless-m4t-medium": {},
    "paligemma-3b": {},
    "zamba2-2.7b": {},
    "xlstm-350m": dict(n_layers=7),
}


def _inputs(cfg, rng):
    """(JAX batch, port batch) of seeded tokens and the family's stub inputs."""
    tokens = rng.integers(0, cfg.vocab, (BATCH, PROMPT))
    arrays = {"tokens": tokens}
    if cfg.family == "vlm":
        arrays["img_embed"] = rng.normal(size=(BATCH, cfg.n_img_tokens, 1152)).astype(np.float32)
    if cfg.family == "encdec":
        arrays["frames"] = rng.normal(size=(BATCH, PROMPT // cfg.audio_downsample,
                                            1280)).astype(np.float32)
    jb = {k: jnp.asarray(a, jnp.int32 if k == "tokens" else jnp.float32)
          for k, a in arrays.items()}
    return jb, {k: torch.from_numpy(a) for k, a in arrays.items()}


@pytest.fixture(scope="module", params=list(CASES))
def family(request):
    """One family's JAX run (prefill and DECODE greedy steps), computed
    once, and the port's model holding the same weights."""
    name = request.param
    jcfg, cfg = jreduced(JAX_ARCHS[name], **CASES[name]), reduced(get_arch(name),
                                                                  **CASES[name])
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jb = jzoo.get_model(jcfg)
    params, _ = jb.init(jax.random.PRNGKey(0))
    params = randomize_constants(params, np.random.default_rng(1))
    jbatch, tbatch = _inputs(cfg, np.random.default_rng(2))
    max_len = (cfg.n_img_tokens or 0) + PROMPT + DECODE
    jl, jc = jb.prefill(params, jbatch, max_len=max_len)
    steps = [(np.asarray(jl), port_cache_from_jax(jc, cfg), None)]
    for _ in range(DECODE):
        tok = np.asarray(jnp.argmax(jl[:, :cfg.vocab], -1)).astype(np.int64)
        jl, jc = jb.decode_step(params, jc, {"token": jnp.asarray(tok, jnp.int32)})
        steps.append((np.asarray(jl), port_cache_from_jax(jc, cfg), tok))
    return dict(name=name, cfg=cfg, params=params, model=to_torch_model(params, cfg),
                batch=tbatch, max_len=max_len, steps=steps)


def test_prefill_and_decode_match_jax(family):
    cfg, model = family["cfg"], family["model"]
    bundle = model_zoo.get_model(cfg)
    tl, tc = bundle.prefill(model, family["batch"], max_len=family["max_len"])
    jl, jcache, _ = family["steps"][0]
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (BATCH, cfg.vocab_padded)
    assert_close(tl, jl, TOL, TOL, "prefill logits")
    of_largest = cfg.family == "xlstm"
    assert_cache_close(tc, jcache, TOL, TOL, "prefill cache", of_largest)
    for step, (jl, jcache, tok) in enumerate(family["steps"][1:]):
        np.testing.assert_array_equal(np_(tl[:, :cfg.vocab].argmax(-1)), tok, f"step {step}")
        tl, tc = bundle.decode_step(model, tc, {"token": torch.from_numpy(tok)})
        assert_close(tl, jl, TOL, TOL, f"decode {step} logits")
        assert_cache_close(tc, jcache, TOL, TOL, f"decode {step} cache", of_largest)


def test_make_cache_matches_jax(family):
    cfg = family["cfg"]
    jc = jzoo.get_model(jreduced(JAX_ARCHS[family["name"]], **CASES[family["name"]])
                        ).make_cache(3, 20)
    tc = model_zoo.get_model(cfg).make_cache(3, 20, device="cpu")
    assert_cache_close(tc, port_cache_from_jax(jc, cfg), 0, 0, "make_cache")


def test_params_from_jax_places_every_leaf(family):
    """Every JAX leaf lands in the port's model (params_from_jax checks the
    key sets); spot-check a stacked one against its source."""
    model, params, cfg = family["model"], family["params"], family["cfg"]
    n = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n
    if cfg.family == "hybrid":
        np.testing.assert_array_equal(np_(model.blocks[3].in_proj),
                                      np.asarray(params["groups"]["m1"]["in_proj"][1]))
    if cfg.family == "xlstm":
        assert [b.kind for b in model.blocks] == ["m"] * 5 + ["s", "m"]
        np.testing.assert_array_equal(np_(model.blocks[5].r),
                                      np.asarray(params["groups"]["sub5"]["r"][0]))
        np.testing.assert_array_equal(np_(model.blocks[6].wq),
                                      np.asarray(params["rem0"]["wq"]))


def test_forward_matches_jax(family):
    """The uncached forward (final hidden states over the prompt), and for
    the enc-dec its encoder."""
    cfg, model, name = family["cfg"], family["model"], family["name"]
    jcfg = jreduced(JAX_ARCHS[name], **CASES[name])
    jfam = jzoo._family(jcfg)
    params, batch = family["params"], family["batch"]
    tokens, jtokens = batch["tokens"], jnp.asarray(batch["tokens"].numpy(), jnp.int32)
    if cfg.family == "encdec":
        frames = batch["frames"]
        ours = encdec.encode(model, frames)
        theirs = jencdec.encode(params, jnp.asarray(frames.numpy()), jcfg)
    elif cfg.family == "vlm":
        img = batch["img_embed"]
        ours = dense.forward(model, tokens, img_embed=img)
        theirs = jfam.forward(params, jtokens, jcfg, img_embed=jnp.asarray(img.numpy()))
    else:
        ours = model_zoo.family_module(cfg).forward(model, tokens)
        theirs = jfam.forward(params, jtokens, jcfg)
    assert_close(ours, theirs, TOL, TOL, "hidden states")


def test_vlm_prefix_covers_the_image_tokens():
    """paligemma: the image tokens sit in front (pos and the caches count
    them), they see each other both ways, and the text stays causal: a
    later image embedding moves an earlier image row's cache entry only
    through the prefix, a later token moves no earlier position."""
    cfg = reduced(get_arch("paligemma-3b"), n_layers=2)
    bundle = model_zoo.get_model(cfg)
    model = bundle.init(seed=0, device="cpu")
    rng = np.random.default_rng(7)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 6)))
    img = torch.from_numpy(rng.normal(size=(1, cfg.n_img_tokens, 1152)).astype(np.float32))
    _l, c = bundle.prefill(model, {"tokens": tok, "img_embed": img})
    assert c["pos"] == cfg.n_img_tokens + 6
    assert tuple(c["layers"][0]["k"].shape[:2]) == (1, cfg.n_img_tokens + 6)
    img2 = img.clone()
    img2[0, -1] += 1.0
    _l2, c2 = bundle.prefill(model, {"tokens": tok, "img_embed": img2})
    # layer 1's keys: image row 0 sees the changed last image row (prefix)
    assert not torch.allclose(c2["layers"][1]["k"][0, 0], c["layers"][1]["k"][0, 0])
    tok2 = tok.clone()
    tok2[0, -1] = (tok[0, -1] + 1) % cfg.vocab
    _l3, c3 = bundle.prefill(model, {"tokens": tok2, "img_embed": img})
    n = cfg.n_img_tokens + 5
    assert torch.equal(c3["layers"][1]["k"][0, :n], c["layers"][1]["k"][0, :n])
