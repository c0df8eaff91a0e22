#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    PYTHONPATH=src python3 chip_smoke.py [--frames 16] [--syncs 8] [--clients 8]
                                         [--blocks 24] [--out FILE]

Phases, each of which raises on failure (the script then exits non-zero):
  1. build every CUDA kernel of the port from `src/repro_torch/kernels/csrc`;
  2. build the city scene and its LoD tree, size the session's budgets;
  3. hold K1-K4 against their plain PyTorch versions on the card, at the
     shapes of the session's first frames, and time both (CUDA events and
     the profiler's device time); hold K4 also at n_cat = 44 (the VR rig at
     tile 8) and with ranks repeated inside a row, on the session's own
     ranks; K3 also on the queue less K3_TAIL rows (a tail block); K2 on
     the session's tiles at eps_t > 0 (tiles that stop inside a window)
     and on the adversarial tiles of `tests/_raster_cases.py`;
  4. check, on a small input, that the tiled stereo render agrees with the
     untiled per-pixel reference;
  5. run the single-client collaborative session with the compressed Δcut
     wire (LoD sync every 4 frames, stereo render every frame) with every
     launch counter set to 0 first, and require that K1, K3, K4, K2, K5
     and the binning chain launched, the chain once a frame; then check
     each sync's cut against a full search, hold the binning chain against
     `bin_tiles_plain` on the last frame's inputs and time both (CUDA
     events, the profiler's device time by kernel), and time the stages of
     one more frame;
  6. trace one more sync and rendered frame with torch.profiler (device
     busy time and the kernels that take it);
  7. run the fleet: B clients on the same tree in a pooled `LodService`
     (foveated τ, encode-once Δ stream), one sync every 4 frames of each
     client's walk, then one pooled fallback render of every client, with
     the counters set to 0 first; require that K6, K5, K2 and the binning
     chain launched, K2 once; time each sync's stages;
  8. hold K5 and K6 against their plain versions at the fleet's shapes (the
     cold sync's Δ-union, the first warm sync's pooled bucket), the binning
     chain against `bin_tiles_plain` on each client's inputs to the pooled
     render, the pooled
     fallback render against the per-client one, and two pooled syncs of a
     fresh fleet against two vmapped ones;
  9. serve qwen2.5-3b as published (36 layers, bf16, seeded weights) through
     `model_zoo.get_model`: with the counters set to 0, prefill 4 requests
     of 2048 tokens (max_len 2048 + 32) and take 32 greedy decode steps;
     require that K7 launched 36 times, once a layer, all in the prefill;
     time the prefill and the steps, read the peak memory and profile one
     more prefill (K7's share) and one more decode step (the device's idle
     share). Then, in float32 at full width and 4 layers,
     hold (a) the prefill logits against the same model with K7's plain
     version substituted, and (b) decode step t's logits against a prefill
     over the prompt and the t tokens decoded, each within 1e-4 of the
     largest |logit|. In bf16 at full depth, report the prefill logits' gap
     and the greedy tokens' agreement (teacher-forced) against the model
     with K7's plain version substituted (the same rounding points) and
     against the model with `models.attention.attention_plain` substituted
     (the JAX serving path's rounding: q and p kept in float32);
 10. hold K7 against its plain version at phase 9's prefill shape (bf16 and
     float32), a gemma3-4b local layer (head dim 320, window 1024; bf16 and
     float32), a non-causal one, and phase 14's new call patterns (the
     granite-moe and qwen3-moe prefills, 16/8 and 64/4 heads of 64; a
     seamless encoder layer, non-causal 16/16 heads of 64 over 512 frames,
     and its causal decoder self-attention over 2048; zamba2's shared block,
     32/32 heads of 80, which the bf16 kernel pads to 128, also timed at
     head dim 128 to show what the padding costs) and phase 15 (a)'s
     training forward (1 x 16/2 heads of 128 over 4096, causal; bf16, and
     float32 as phase 15 (b) runs it) and phase 15 (d)'s two (gemma3-4b's
     local and global layers, 1 x 8/4 heads of 320 over 4096, window 1024
     and causal; bf16), each shape
     taken from its config, and time each beside its bound and
     `scaled_dot_product_attention` (K7's share of its bound, and its time
     over the library call's); then K7's backward kernel, in bf16 and
     float32, at phase 15 (a)'s training shape, at the family patterns
     phase 15 (c) trains through K7 (granite-moe's 16/8 heads of 64,
     seamless's non-causal encoder over 512 frames, zamba2's head dim 80),
     at gemma3-4b's local layer (batch 1, head dim 320, window 1024), at
     paligemma-3b's heads (batch 1, 8/1 heads of 256, causal) and at phase
     15 (d)'s two (gemma3-4b's local and global layers over 4096), each against
     `flash_attention_backward_plain` and against the plain version's
     autograd gradient within `K7_BWD_TOL` (1e-5 float32, 2e-2 bf16) of
     each gradient's largest |value|, two runs equal bit for bit, timed
     beside its bound, the plain version, the route it replaced (autograd
     through the plain version) and `scaled_dot_product_attention`'s
     backward, with the kernel's route (`wgmma` for bf16, `tf32x3` for
     float32) and each pass's blocks logged, zamba2's head dim 80 also
     timed at its bucket's 128; every float32 row (forward and backward)
     takes its bound at three TF32 products a product (495 / 3 TFLOP/s),
     the float32 units' bound beside it. Every row's device time (forward
     and backward) comes from the profiler in a process of its own
     (`--k7-device-ms`), started after the rows: in a whole run the
     profiler recorded none of this phase's forward launches;
 11. (run after phase 8, on phase 7's scene, before the LM phases free it)
     the ragged fleet, with the counters set to 0 first: a pooled service of
     8 clients at capacity 8 (max_clients 16, bandwidth tiers phone /
     headset / tethered, phase 7's foveated τ) on seeded walks takes 2 syncs,
     4 admits (the first grows the slots to 16), 2 syncs, 3 evicts and an
     admit into a recycled slot, a seeded lost page and its NACK, syncs until
     that client's debt is repaid, evicts to 8 clients, a pooled fallback
     render with 8 free slots, a shrink to 8 slots, 2 syncs, 24 deadline
     scheduler ticks on straggler and bursty motion (beside lockstep syncs
     on the same motion) and one more pooled render. A vmapped service (K1)
     takes the same script up to the scheduler and must equal it after every
     sync (cuts, debt, fleet leaves, every stats column, `sync_bytes` bit for
     bit); the survivors' cuts must not move across the shrink; the NACKed
     client's resident count must equal a loss-free run's once its debt is
     repaid; each render must equal the per-client render bit for bit, its
     free slots black; K6 (its largest launch and its first at a clamp) and
     K5 (its largest) must equal their plain versions on the path's inputs.
     K6 must launch on every pooled sync with stale pairs, K5 on every sync,
     K2 once a render. The check services', the pair sizing's and the
     reference renders' launches are counted apart, not as the path's.
     It prints the lifecycle events' times, the warm sync at capacity 16,
     each tier's allowance and τ scale, the scheduler's and lockstep's MTP
     p50/p99 and miss rates and the distinct K5/K6 launch sizes, each with
     the card's name and power limit.
 12. (run after phase 11, on phase 7's scene, before the LM phases free it)
     recovery, with the counters set to 0 first: a pooled service like
     phase 11's (8 clients at capacity 8, max_clients 16, the three tiers,
     foveated τ, phase 11's cut budget), driven through
     `RecoveryManager(every=4, keep=2)` in a temporary directory, takes 2
     syncs, 4 admits (8 -> 16 slots), a bandwidth re-tier, 3 syncs, 2
     evicts, a seeded lost page and its NACK, and 2 syncs. Then it crashes
     (every reference dropped, half a record appended to the journal) and
     `recover` restores the newest snapshot onto the card and replays the
     journal's tail (syncs and the NACK among it). A vmapped twin (K1) that
     never crashed takes the same script: the recovered service must equal
     it bit for bit (every state leaf, host mirror and stats column) right
     after the recovery and after each of 4 more syncs, and its pooled
     fallback render must equal the twin's, free slots black. Then a leaf
     file of the newest snapshot is truncated, and `recover` must fall back
     to the one before it and replay the longer tail to the same bits. K6
     and K5 must launch in the replays and equal their plain versions at
     the largest launches. It prints each snapshot's ms (copy to the host,
     write) and bytes on disk, a sync that snapshots beside ones that do
     not, each restore's ms (read, copy to the card), the records replayed
     and the replay's ms, and the total, each with the card's name and
     power limit. The twin's, the pair sizing's and the twin render's
     launches are counted apart; the directory is removed at the end.
 13. (run after phase 12, on phase 7's scene, before the LM phases free it)
     the serving mesh, with the counters set to 0 first. (a) In this process,
     a 1x1 mesh (NCCL, a world of one): a meshed service like phase 11's (8
     clients at capacity 8, max_clients 16, the three tiers, foveated τ,
     phase 11's cut budget) and a meshless twin take one script: 2 syncs, 4
     admits (8 -> 16 slots), 2 syncs, 3 evicts, a sync, a seeded lost page
     and its NACK, a sync, 6 deadline-scheduler ticks on a scripted clock
     (partial syncs), an evict and a shrink to 8 slots, a sync,
     `resize_mesh(None)`, a sync, `resize_mesh` back, a sync, a pooled
     render; every sync, tick and the render must be bitwise the twin's,
     and a snapshot of the meshed service must restore meshless to the
     twin's bits. (b) Four gloo ranks time-sharing the card on a 2x2 mesh
     (`--mesh-rank`: this script as a child), which load phase 7's tree
     from a file this process writes: 8 clients at capacity 16 (8 slots a
     client shard) take 6 syncs with an admit and an evict and a pooled
     render; every sync's whole-fleet stats, every slot's frames (sha256)
     and a snapshot restored meshless must be the meshless service's bits,
     `fleet_totals` within rtol 1e-6; K6, K5, K2, K3 and K4 must launch on
     every rank. It prints the meshed and meshless warm sync, each rank's
     syncs and the collectives' share, and each rank's resident bytes
     against the meshless service's, each with the card's name and power
     limit. A rank that exits non-zero fails the phase.
 14. (run after phase 10) serve every other LM family through
     `model_zoo.get_model`, one config at a time, each freed before the
     next: granite-moe-1b-a400m (24 layers), qwen3-moe-235b-a22b (4 of its
     94 layers: 470 GB in bf16 whole), seamless-m4t-medium (12 encoder + 12
     decoder layers, 512 stub audio frames of 1280), paligemma-3b (18
     layers, 256 stub image embeddings of 1152 in front), zamba2-2.7b (54
     Mamba2 blocks, the shared block applied 9 times) and xlstm-350m (24
     blocks), at full width in bf16 from seeded weights: with the counters
     set to 0, prefill 4 requests of 2048 tokens and take 16 greedy decode
     steps; require that K7 launched exactly as often as the family's
     self-attention over the whole sequence runs (24, 4, 24, 0, 9, 0), all
     in the prefill; time the prefill and the steps (xlstm's sLSTM time
     loops apart), read the peak memory, profile one more prefill where K7
     runs (its share of the device time) and one more decode step (the
     device's idle share). Then, in float32 at full width and cut depth
     (MoE 4 layers at capacity factor 8; enc-dec 2 + 2; paligemma 4;
     zamba2 one group of 6; xlstm one 6-block group), hold (a) where K7
     runs, the prefill logits against the same model with K7's plain
     version substituted (MoE: on the same experts, the plain run taking
     the K7 run's top-k choices with its own weights at them, since a
     token near a tie changes experts under a float32 rounding's
     difference; there the router's probabilities are held too, and every
     token the plain router would route differently while the layers
     before routed alike must be one where the K7 run's router was within
     the tolerance of a tie; the free-routing gap, the tokens routed
     differently and the largest margin are printed), and (b) decode step
     t's logits against
     a prefill over the prompt and the t tokens decoded, each within
     `FAMILY_REL_TOL` of the largest |logit|.
 15. (run after phase 14) train on the card: (a) qwen2.5-3b as published
     (36 layers, bf16, remat, seeded weights, float32 AdamW moments)
     through `train.train_step.make_train_step` on `SyntheticTokens`
     batches of 1 x 4096 tokens (train_4k's length; its global batch of
     256 cut to 1 for one card): one warm-up step, in which every
     parameter's gradient must be finite and non-zero, then, with the
     counters set to 0, 5 timed steps; require finite losses, the last
     below the first, K7 launched 72 times a step (36 forwards and 36
     remat recomputes) and its backward kernel 36 times; report the step's
     median ms, tokens/s, model FLOPs and MFU against 989 TFLOP/s, peak
     memory, the device's idle share (1 - the kernels' device time in one
     profiled step over the median unprofiled step) and the backward
     kernel's share of that device time, read from the same trace. (Phase
     10 holds K7 and its backward against their plain versions at this
     training shape.) (d) gemma3-4b as published (34 layers, d_model 2560,
     8/4 heads of 320, vocab 262,144, window 1024 on 5 of each 6 layers)
     likewise, after (a)'s model is freed: one warm-up step and 3 timed
     steps, K7's forward and backward at head dim 320 on `wgmma` (the
     backward 34 times a step); all 34 layers fit the card (a peak of
     65.05 GiB on an H100 80GB), so no depth is cut. (b) In float32 at
     full width and 4 layers, the loss and every parameter's gradient with
     K7 (forward and backward kernels, the backward launched 4 times)
     against the model with `attention_plain` substituted, within 1e-4 of
     each leaf's largest |grad|. (c) Every family at `reduced` float32 size
     (qwen2.5-3b, granite-moe, seamless, paligemma, zamba2, xlstm at 7
     blocks) takes 20 steps through the `Trainer` (zamba2 with int8
     gradients), with a checkpoint every 10 steps and a fault injected at
     step 15; require one restart, the run's end, finite and falling
     losses, every gradient non-zero, K7 launched
     `model_zoo.k7_train_launches` times a step run and its backward
     `model_zoo.k7_backward_launches` times.
 16. (run after phase 15) the sharding context and the dry-run: (a) on a
     1x1 mesh (NCCL, a world of one, `launch.mesh.make_mesh`), qwen2.5-3b
     as published has its parameters placed by `make_shardings` and runs
     under `meshed(activation_rules(mesh))`: phase 9's prefill of 4 x 2048
     and 8 greedy decode steps against the same model meshless (its
     weights then placed on the mesh), and 2 of phase 15 (a)'s train steps
     against a meshless run from the same seed; require K7 36 times in the
     meshed prefill and 72 times a meshed step, its backward 36 times a
     meshed step (all per shard, inside `local_map`), and logits, greedy tokens
     and losses equal bit for bit (else within 1e-4 of the largest
     |value|, the gap printed); print both runs' prefill, decode and step
     ms. (b) `launch.dryrun` cells in processes of their own, all started
     together, each with a fake world of 256 or 512 ranks (`DRYRUN_CELLS`:
     qwen2.5-3b's train_4k, prefill_32k and decode_32k on both production
     meshes, granite-moe's train_4k on one pod); require every cell `ok`
     and print its bytes a device against 80 GB, FLOPs, collectives,
     roofline terms and trace seconds. (c) The 1x1 dry-run of phase 15
     (a)'s step (1 x 4096): its argument bytes, less the batch and the
     step counter, must equal the parameters' and moments' bytes, which
     must equal what the caching allocator was asked for when (a) built
     them (`memory_stats` "requested_bytes", less the counter's 4 B; the
     growth of `memory_allocated`, its rounded blocks, is printed beside
     it); print its predicted peak
     beside phase 15's measured one and its roofline bound beside the
     measured step.
The build phase prints each kernel's registers, static shared memory and
spills from the compiler's `-Xptxas -v` lines (K7's backward kernels by
element type, head-dim bucket and blocks; the wgmma ones by bucket and
k-steps; K7's float32 kernels by bucket; the phase fails if a wgmma
backward kernel or a float32 one spills), and the SASS instructions
of K2's hot loop per pixel-entry (`repro_torch.kernels.sass`). Every
kernel's time is printed by events and by device time (profiler).
The kernel report's `launches_by_path` has an entry a path (session, fleet,
ragged, recovery, mesh, lm, families, train, lm_mesh); K7's backward has
its own line (`flash_attention_backward`, at the training shape in bf16).
The last three lines are the kernel
report (JSON), the card's name and power limit, and {"ok": true, "device": ...}.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

REPS = 10                    # timed kernel launches (median)
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory
FP32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
TF32_OPS_PER_S = 495e12      # H100 SXM TF32 tensor cores, dense
# K7's float32 kernels: three TF32 products a float32 product (csrc/tf32x3.cuh)
TF32X3_OPS_PER_S = TF32_OPS_PER_S / 3
BF16_OPS_PER_S = 989e12      # H100 SXM bf16 tensor cores, dense
LM_ARCH = "qwen2.5-3b"
LM_BATCH = 4                 # phase 9: requests
LM_PROMPT = 2048             # prompt tokens each
LM_STEPS = 32                # greedy decode steps
LM_CHECK_LAYERS = 4          # depth of the float32 checks of phase 9
LM_REL_TOL = 1e-4            # of the largest |logit|
WINDOW_ARCH = "gemma3-4b"    # phase 10's sliding-window case, head dim 320
# phase 14: (config, layers kept at full width: None = all of them)
FAMILY_ARCHS = (("granite-moe-1b-a400m", None), ("qwen3-moe-235b-a22b", 4),
                ("seamless-m4t-medium", None), ("paligemma-3b", None),
                ("zamba2-2.7b", None), ("xlstm-350m", None))
FAMILY_STEPS = 16            # phase 14: greedy decode steps
FAMILY_REL_TOL = 1e-4        # phase 14's checks (a) and (b), of the largest |logit|
# phase 14's float32 checks: depth cut a family, at full width
FAMILY_CHECK_CUT = {"moe": dict(n_layers=4, capacity_factor=8.0),
                    "encdec": dict(n_enc_layers=2, n_layers=2),
                    "vlm": dict(n_layers=4), "hybrid": dict(n_layers=6),
                    "xlstm": dict(n_layers=6)}
K4_TILES = 4096              # phase 3's extra K4 cases: this many of the session's tiles
K2_STOP_EPS = (1e-3, 2e-2)   # phase 3: eps_t at which the session's tiles stop early
# phase 3: α overrides (the second and third: no stop; the third: every α < 0)
K2_THRESHOLDS = ((0.05, 0.5), (1 / 255, 1.5), (-0.5, -0.1))
K2_WINDOW = 8                # rasterize.cu's kW: entries K2 blends between two votes
K3_TAIL = 37                 # phase 3: K3 also on the queue less this many rows


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int) -> float:
    """Median milliseconds of `fn` on the card: CUDA events around a run of
    back-to-back calls (enough for about 1 ms, at most 50), after a
    warm-up, over the count; `reps` such runs. A call shorter than the
    host's time to issue it would otherwise be timed with the idle gap
    before it."""
    def run(n: int) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n

    fn()
    torch.cuda.synchronize()
    n = min(50, max(1, round(1.0 / max(run(1), 1e-3))))
    return statistics.median(run(n) for _ in range(reps))


def bound(bytes_moved: float, ops: float, tf32_ops: float = 0.0):
    """(ms, "bytes" or "operations"): the largest of the bytes over the
    memory rate, the float32 operations over their peak and the TF32
    operations over theirs (the tensor cores and the float32 units are
    separate pipes, so their times overlap)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops / FP32_OPS_PER_S, tf32_ops / TF32_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def pow2_at_least(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


def require_launched(path: str, counts: dict, names) -> None:
    missing = [k for k in names if counts[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the {path} path: {missing}")


def require_filtered(path: str, counts: dict) -> dict:
    """K5's counters over a path's run: every row took the tensor-core
    filter (SH coefficients are finite and small), none the full scan."""
    log(f"[{path}] K5 rows: filtered {counts['filtered']}, full scan {counts['scanned']}, "
        f"second pass {counts['second_pass']}; candidates {counts['candidates']} (most in "
        f"a row {counts['most_candidates']})")
    if counts["filtered"] <= 0 or counts["scanned"] != 0:
        raise AssertionError(f"K5 on the {path} path: not every row went through the "
                             f"filter: {counts}")
    return counts


def bin_chain_check(torch, BN, kbin, call, what: str):
    """The binning chain (`core.binning.bin_tiles` on CUDA tensors, one
    launch of `kbin.bin_tiles_kernel`) against `bin_tiles_plain` on the same
    inputs, `call` = (args, kwargs): lists, counts and the overflow flag
    exactly. Returns the chain's TileLists."""
    a, kw = call
    before = kbin.bin_tiles_kernel.launches
    got = BN.bin_tiles(*a, **kw)
    launched = kbin.bin_tiles_kernel.launches - before
    want = BN.bin_tiles_plain(*a, **kw)
    torch.cuda.synchronize()
    if launched != 1:
        raise AssertionError(f"binning ({what}): the chain launched {launched} times, not once")
    for name in ("lists", "counts", "overflow"):
        x, y = getattr(got, name), getattr(want, name)
        if not torch.equal(x, y):
            raise AssertionError(f"binning ({what}): {name} differs from the plain version on "
                                 f"{int((x != y).sum())} entries")
    return got


def keep_calls(fn, calls: list, last: bool = False):
    """`fn`, recording each call's (args, kwargs) in `calls` (only the
    latest if `last`)."""
    def run(*a, **kw):
        if last:
            calls.clear()
        calls.append((a, kw))
        return fn(*a, **kw)
    return run


def profiled(torch, what: str, fn) -> dict:
    """Run `fn` under torch.profiler; log and return the wall ms, the device
    busy ms (device-side events only: kernels, copies, sets), the idle share
    and the kernels that take the time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.self_device_time_total > 0:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + ev.self_device_time_total / 1e3
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    if busy_ms > 0:
        log(f"[profile] {what}: wall {wall_ms:.2f} ms (profiler on), device busy "
            f"{busy_ms:.2f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
        for name, t in top:
            log(f"[profile]   {t:9.3f} ms  {name[:90]}")
    else:
        log(f"[profile] {what}: the profiler recorded no device time: not measured")
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms, top=top, by_name=by_name)


def device_ms(torch, fn, key: str, n: int = 10, per_call: int = 1):
    """Device ms a call of `fn` spends in the kernels whose names hold
    `key` (`per_call` launches of them a call; None: every such device
    event of the `n` calls, however many a call makes), from torch.profiler
    over `n` calls after a warm-up, averaged over the calls the launches it
    recorded make up (None if it recorded none): the kernels' own time,
    without the host's issue time that CUDA events around a short call
    also see. The trace starts with a warm-up step, whose records are
    dropped: without it the profiler lost the first launch of a run."""
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True,
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()                  # the warm-up step ends; the recorded one starts
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        prof.step()
    evs = [ev for ev in prof.key_averages()
           if ev.device_type == torch.autograd.DeviceType.CUDA and key in ev.key]
    total, count = sum(ev.self_device_time_total for ev in evs), sum(ev.count for ev in evs)
    if per_call is None:
        return total / 1e3 / n if total > 0 else None
    if count != n * per_call:
        seen = {ev.key[:60]: ev.count for ev in prof.key_averages()
                if ev.device_type == torch.autograd.DeviceType.CUDA}
        log(f"[profile] {key}: the profiler recorded {count} of {n * per_call} launches; "
            f"its device events: {seen}")
    return total / 1e3 / count * per_call if total > 0 else None


def fmt_ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f} ms"


class StageTimer:
    """Host-clock ms of wrapped calls, with a synchronize on both sides."""

    def __init__(self, torch):
        self.torch = torch
        self.ms = {}

    def wrap(self, name, fn):
        def run(*a, **kw):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*a, **kw)
            self.torch.cuda.synchronize()
            self.ms[name] = self.ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
            return r
        return run

    def take(self, name) -> float:
        """The ms accumulated under `name` since the last take (0 if none)."""
        return self.ms.pop(name, 0.0)


def ptxas_report(text: str) -> list:
    """One row per kernel of the build log's `-Xptxas -v` lines: a short
    name (the kernel's identifier and its template numbers), registers,
    static shared memory and spill bytes."""
    import re
    rows = []
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            mangled, pos, ident = m.group(1), 0, m.group(1)
            if mangled.startswith("_ZN"):   # <length><name> ... : the last name is the kernel
                pos = 3
                while (d := re.match(r"\d+", mangled[pos:])):
                    n, pos = int(d.group()), pos + len(d.group())
                    ident, pos = mangled[pos:pos + n], pos + n
            tmpl = mangled[pos:].split("EE", 1)[0] + "E"
            args = re.findall(r"L[ib](\d+)E", tmpl)
            elem = ("bf16" if "__nv_bfloat16" in tmpl else "f32" if tmpl.startswith("If")
                    else None)
            args = ([elem] if elem else []) + args
            rows.append(dict(kernel=ident + (f"<{','.join(args)}>" if args else ""),
                             registers=None, smem=0, spill_stores=None, spill_loads=None))
        elif rows:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            if m:
                rows[-1]["spill_stores"], rows[-1]["spill_loads"] = map(int, m.groups())
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                rows[-1]["registers"] = int(m.group(1))
                sm = re.search(r"(\d+) bytes smem", ln)
                rows[-1]["smem"] = int(sm.group(1)) if sm else 0
    return rows


def rel_err(a, b) -> float:
    """max |a - b| over the largest |b|."""
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


RAGGED_START = 8             # phase 11: clients at the start (capacity 8)
RAGGED_MAX = 16              # phase 11: max_clients
RAGGED_TIERS = ("phone", "headset", "tethered")   # client c's tier: c mod 3
RAGGED_TICKS = 24            # phase 11: scheduler ticks on the real clock
RAGGED_NACK_SYNCS = 48       # phase 11: at most this many syncs to repay the NACK
RAGGED_SEED = 11


def ragged_fleet(torch, dev, tree, extent, base, focal, width, height, pair_total,
                 card) -> dict:
    """Phase 11 of the module docstring, on phase 7's scene (`tree`,
    `extent`, its rig size and focal). Raises on a failed check; returns the
    phase's report, with the launch counts of all of it under "counts"."""
    import numpy as np
    from repro_torch import kernels as K
    from repro_torch import render as R
    from repro_torch.core import camera as C
    from repro_torch.core import compression as CP
    from repro_torch.core import lod_search as LS
    from repro_torch.core import pipeline as P
    from repro_torch.kernels import lod_cut, vq_assign
    from repro_torch.serve import lod_service as SV
    from repro_torch.serve import scheduler as SCH

    K.reset_launch_counts()
    w, (ex, ey) = base.w, extent
    rng = np.random.default_rng(RAGGED_SEED)
    n_walk = RAGGED_START + 5
    n_frames = (7 + RAGGED_NACK_SYNCS) * w + 1
    walks = [np.stack([cam.pos.numpy() for cam in C.walk_trajectory(
        C.TrajectoryConfig(seed=c), n_frames, extent, focal_px=focal, width=width,
        height=height, device="cpu")]).astype(np.float32) for c in range(n_walk)]

    def tier(c):
        return RAGGED_TIERS[c % 3]

    def tau(c):
        return 48.0 if c % 2 == 0 else 84.0

    # the scheduler's motion, in the city's frame: 2 stragglers teleporting
    # about the centre at eye height, 6 bursty heads from where they stand
    centre = np.asarray([ex / 2, ey / 2, 1.7], np.float32)
    lo = np.asarray([0.02 * ex, 0.02 * ey, 1.2], np.float32)
    hi = np.asarray([0.98 * ex, 0.98 * ey, 3.0], np.float32)
    strag = [SCH.straggler_path(rng, RAGGED_TICKS, teleport_every=4,
                                extent=0.4 * min(ex, ey)) for _ in range(2)]
    strag = [np.concatenate([p[:, :2] + centre[:2], np.full((RAGGED_TICKS, 1), 1.7)],
                            axis=1).astype(np.float32) for p in strag]
    burst_steps = [SCH.bursty_motion_path(rng, RAGGED_TICKS, speed=0.8, burst_prob=0.2,
                                          burst_scale=12.0) for _ in range(6)]
    deliver = np.ones((RAGGED_TICKS, RAGGED_START), bool)
    deliver[:, :6] = SCH.poisson_arrivals(rng, 1.0, RAGGED_TICKS * 6).reshape(
        RAGGED_TICKS, 6) > 0

    # cut budget: the largest cut at any position the phase visits (walks at
    # their first, middle and last frame; the scheduler's motion from the
    # walks' middle), as a power of two; an overflow later fails the phase
    probe = [(walks[c][f], tau(c)) for c in range(n_walk)
             for f in (0, n_frames // 2, n_frames - 1)]
    probe += [(p[t], 84.0) for p in strag for t in range(RAGGED_TICKS)]
    probe += [(np.clip(walks[c][n_frames // 2] + b[t], lo, hi), 48.0)
              for c, b in enumerate(burst_steps) for t in range(RAGGED_TICKS)]
    max_cut = max(int(LS.full_search(tree, torch.as_tensor(pos, device=dev), focal,
                                     t_)[0].count()) for pos, t_ in probe)
    cfg = P.SessionConfig(tau=48.0, w=w, w_star=32, cut_budget=pow2_at_least(max_cut))
    K.reset_launch_counts()
    log(f"[ragged] {len(probe)} probe positions: largest cut {max_cut} -> cut_budget "
        f"{cfg.cut_budget}; {RAGGED_START} clients at capacity {RAGGED_START}, "
        f"max_clients {RAGGED_MAX}, tiers {RAGGED_TIERS} by client id mod 3")

    # what the check services, the render's pair sizing and the reference
    # renders launch is not the path: it is counted here and subtracted
    aside = dict.fromkeys(K.launch_counts(), 0)
    checking = [False]

    @contextlib.contextmanager
    def not_the_path():
        before = K.launch_counts()
        checking[0] = True
        try:
            yield
        finally:
            checking[0] = False
            for name, n in K.launch_counts().items():
                aside[name] += n - before[name]

    def make(mode):
        return SV.LodService(tree, cfg, RAGGED_START, focal=focal, mode=mode,
                             taus=[tau(c) for c in range(RAGGED_START)],
                             capacity=RAGGED_START, max_clients=RAGGED_MAX,
                             bandwidth=[tier(c) for c in range(RAGGED_START)])

    pooled = make("pooled")
    with not_the_path():
        others = {"vmapped": make("vmapped"), "lossfree": make("pooled")}
    for svc in others.values():
        svc.codec = pooled.codec
    # the sizes K6 and K5 are launched at on the path, and the caps their
    # pow2 buckets are clamped to (the pool of (slot, slab) pairs; the
    # Δ-stream budget); the arguments of each one's largest launch and of
    # its first launch at a clamp, held against the plain version after
    shapes = {"k6_pairs": set(), "k5_rows": set()}
    caps = {"k6_pairs": set(), "k5_rows": set()}
    kept = {"k6_pairs": {}, "k5_rows": {}}

    def recorder(key, fn, dim):
        def run(*a, **kw):
            if not checking[0]:
                n = int(a[0].shape[dim])
                shapes[key].add(n)
                caps["k6_pairs"].add(pooled.capacity * tree.meta.Ns)
                caps["k5_rows"].add(pooled.delta_budget)
                if n > kept[key].get("largest", (0,))[0]:
                    kept[key]["largest"] = (n, a, kw)
                if n & (n - 1) and "clamped" not in kept[key]:
                    kept[key]["clamped"] = (n, a, kw)
            return fn(*a, **kw)
        return run

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def both(op, *args):
        """A lifecycle op on the pooled service (timed), then on the others."""
        out, ms = timed(lambda: getattr(pooled, op)(*args))
        with not_the_path():
            for svc in others.values():
                if getattr(svc, op)(*args) != out:
                    raise AssertionError(f"{op}{args}: the services disagree")
        return out, ms

    def check_kernels(stats, before, what):
        after = K.launch_counts()
        k6 = after["lod_pair_sweep"] - before["lod_pair_sweep"]
        k5 = after["vq_assign"] - before["vq_assign"]
        stale = int(stats.resweeps.sum())
        if k6 != (1 if stale else 0) or k5 < 1:
            raise AssertionError(f"{what}: {stale} stale pairs, K6 launched {k6} times, "
                                 f"K5 {k5}")
        return stale

    def agree(a, b, what, sa=None, sb=None):
        for fld in dataclasses.fields(sa) if sa is not None else ():
            if not torch.equal(getattr(sa, fld.name), getattr(sb, fld.name)):
                raise AssertionError(f"{what}: pooled and vmapped {fld.name} differ")
        for name, x, y in (("cut ids", a.state.cut_gids, b.state.cut_gids),
                           ("pending", a.state.pending, b.state.pending),
                           *((f"fleet {f.name}", getattr(a.state.fleet, f.name),
                              getattr(b.state.fleet, f.name))
                             for f in dataclasses.fields(a.state.fleet))):
            if not torch.equal(x, y):
                raise AssertionError(f"{what}: pooled and vmapped {name} differ")
        if not (np.array_equal(a._allowance, b._allowance)
                and np.array_equal(a._tau_scale, b._tau_scale)):
            raise AssertionError(f"{what}: pooled and vmapped controllers differ")

    rows, trajectory, sync_t = [], {t: [] for t in RAGGED_TIERS}, [0]

    def sync(what):
        t = sync_t[0]
        sync_t[0] += 1
        cams = {c: walks[c][t * w] for c in pooled.active_ids}
        before = K.launch_counts()
        st, ms = timed(lambda: pooled.sync(cams))
        stale = check_kernels(st, before, what)
        if bool(st.overflow.any()):
            raise AssertionError(f"{what}: a cut overflowed {cfg.cut_budget}")
        with not_the_path():
            if "vmapped" in others:
                agree(pooled, others["vmapped"], what, st, others["vmapped"].sync(cams))
            if "lossfree" in others:
                others["lossfree"].sync(cams)
        batch = pooled.last_delta
        row = dict(what=what, ms=ms, capacity=pooled.capacity, live=pooled.n_clients,
                   stale_pairs=stale, union=int(batch.n_union),
                   width=int(batch.union_gids.shape[0]), pages=int(batch.pages),
                   shipped=int(st.delta_shipped.sum()),
                   deferred=int(st.delta_deferred.sum()))
        rows.append(row)
        for c in (0, 1, 2):
            _target, allow, scale = pooled.client_bandwidth(c)
            trajectory[tier(c)].append((allow, scale))
        log(f"[ragged sync {t}] on {card}: {what}: {ms:.2f} ms, {row['live']} live in "
            f"{row['capacity']} slots; stale pairs {stale}; Δ-union {row['union']} in "
            f"width {row['width']}, {row['pages']} pages; shipped {row['shipped']}, "
            f"owed {row['deferred']}")
        return st

    def rigs_of(ids):
        """A rig for each live client, looking at the city's centre from
        where the service last synced it."""
        rigs = []
        for c in ids:
            pos = pooled._slot_cams[pooled._slot_of(c)]
            target = centre if np.linalg.norm(centre[:2] - pos[:2]) > 1.0 else pos + [10, 10, 0]
            rigs.append(C.StereoRig(left=C.make_camera(pos, target, focal_px=focal,
                                                       width=width, height=height,
                                                       near=0.25, device=dev),
                                    baseline=0.06))
        return rigs

    renders = []

    def render(what):
        """One pooled fallback render of the live clients (one K2 launch),
        held bit for bit against the per-client render of the same service;
        a free slot's frames must be black."""
        ids = pooled.active_ids
        rigs = rigs_of(ids)
        with not_the_path():   # sizing the pair budget projects every queue
            rc = R.RenderConfig.for_fleet(rigs, tile=base.tile, list_len=base.list_len)
            max_pairs = pow2_at_least(max(
                pair_total(SV._masked_queue(tree.gaussians, pooled.client_cut(c)), r, rc)
                for c, r in zip(ids, rigs)))
        before = K.launch_counts()["rasterize_slabs"]
        (fl, fr, fst), ms = timed(lambda: pooled.render_fallback(
            rigs, list_len=base.list_len, max_pairs=max_pairs, path="pooled"))
        k2 = K.launch_counts()["rasterize_slabs"] - before
        if k2 != 1:
            raise AssertionError(f"{what}: the pooled render launched K2 {k2} times, not once")
        with not_the_path():
            vl, vr, vst = pooled.render_fallback(rigs, list_len=base.list_len,
                                                 max_pairs=max_pairs, path="vmap")
            torch.cuda.synchronize()
        if tuple(fl.shape) != (pooled.capacity, height, width, 3) or not (
                torch.isfinite(fl).all() and torch.isfinite(fr).all()):
            raise AssertionError(f"{what}: shape {tuple(fl.shape)} or non-finite")
        live = torch.as_tensor(pooled._active, device=dev)
        if bool(fl[~live].any()) or bool(fr[~live].any()):
            raise AssertionError(f"{what}: a free slot's frame is not black")
        if not (torch.equal(fl, vl) and torch.equal(fr, vr)):
            raise AssertionError(f"{what}: the pooled render differs from the per-client one")
        # as in phase 8: the pooled launch keeps the Pallas contract (no flag
        # past a stop), so it skips at least as many right entries
        for fld in dataclasses.fields(fst):
            a, b_ = getattr(fst, fld.name), getattr(vst, fld.name)
            if not (bool((a >= b_).all()) if fld.name == "right_alpha_skipped"
                    else torch.equal(a, b_)):
                raise AssertionError(f"{what}: frame stats differ from the per-client "
                                     f"render: {fld.name}")
        blank = int((fl[live].flatten(1).amax(1) <= 0).sum())
        if blank == len(ids):
            raise AssertionError(f"{what}: every live client's frame is blank")
        renders.append(dict(what=what, ms=ms, live=len(ids), capacity=pooled.capacity,
                            max_pairs=max_pairs, blank_frames=blank))
        log(f"[ragged] on {card}: {what}: pooled render of {len(ids)} clients in {pooled.capacity} "
            f"slots (max_pairs {max_pairs}) {ms:.1f} ms, {blank} live frames blank; free "
            f"slots black; equal to the per-client render bit for bit")

    events = {}
    with contextlib.ExitStack() as patches:
        patches.enter_context(mock.patch.object(
            SV, "lod_pair_sweep", recorder("k6_pairs", SV.lod_pair_sweep, 0)))
        patches.enter_context(mock.patch.object(
            CP, "vq_assign", recorder("k5_rows", CP.vq_assign, 0)))
        # 1-3: two syncs, four admits (the first grows 8 -> 16), two syncs
        for _ in range(2):
            sync("start")
        for k in range(4):
            c = pooled._next_id
            cid, ms = both("admit", walks[c][sync_t[0] * w], tau(c), True, tier(c))
            events.setdefault("admit_growing" if k == 0 else "admit_in_bucket", []).append(ms)
            if pooled.capacity != 16:
                raise AssertionError(f"admit {cid}: capacity {pooled.capacity}, not 16")
        sync("after admits (cold for 4)")
        sync("warm, 4 slots free")
        warm16_ms = rows[-1]["ms"]
        # 4: three evicts, an admit into a recycled slot
        for c in (3, 4, 8):
            events.setdefault("evict", []).append(both("evict", c)[1])
        c = pooled._next_id
        cid, ms = both("admit", walks[c][sync_t[0] * w], tau(c), True, tier(c))
        events["admit_in_bucket"].append(ms)
        slot = pooled._slot_of(cid)
        if int(pooled.state.fleet.generation[slot]) < 2:
            raise AssertionError(f"client {cid} did not land in a recycled slot")
        # 5: one seeded page of one client (headset or tethered) lost; NACK
        batch = pooled.last_delta
        took = batch.ref_mask.sum(1).cpu().numpy()
        cands = [c for c in pooled.active_ids
                 if c % 3 != 0 and pooled._delta_ids[pooled._slot_of(c)] == c
                 and took[pooled._slot_of(c)] > 0]
        if not cands:
            raise AssertionError("no client took rows of the latest payload")
        victim = int(rng.choice(cands))
        vslot = pooled._slot_of(victim)
        rp = batch.row_page.cpu().numpy()
        page = int(rng.choice(np.unique(rp[batch.ref_mask[vslot].cpu().numpy() & (rp >= 0)])))
        if pooled.delta_checksums().shape != (int(batch.pages),):
            raise AssertionError("page checksums: wrong shape")
        lost, nack_ms = timed(lambda: pooled.nack(victim, [page]))
        with not_the_path():
            lost_v = others["vmapped"].nack(victim, [page])
        if lost <= 0 or lost_v != lost:
            raise AssertionError(f"NACK of page {page} of client {victim}: {lost} rows")
        log(f"[ragged] on {card}: client {victim} ({tier(victim)}) lost page {page}: "
            f"{lost} rows re-queued in {nack_ms:.3f} ms")
        # 6: syncs until the NACKed client's debt is repaid
        for k in range(RAGGED_NACK_SYNCS):
            st = sync(f"repaying the NACK ({k})")
            if int(st.delta_deferred[vslot]) == 0:
                break
        else:
            raise AssertionError(f"client {victim} still owes rows after "
                                 f"{RAGGED_NACK_SYNCS} syncs")
        nack_syncs = k + 1
        lossfree = others.pop("lossfree")
        mine = int(st.client_resident[vslot])
        ref = int(lossfree.state.mgr.client_has[vslot].sum())
        if mine != ref or not torch.equal(pooled.state.cut_gids[vslot],
                                          lossfree.state.cut_gids[vslot]):
            raise AssertionError(f"client {victim}: resident {mine} after the NACK, "
                                 f"{ref} without the loss")
        del lossfree
        # 7: evicts down to 8 live clients, a shrink to 8 slots
        live = pooled.active_ids
        for c in [c for c in reversed(live) if c not in (0, 1, 2, victim)][:len(live) - 8]:
            events["evict"].append(both("evict", c)[1])
        render(f"{pooled.n_clients} live in {pooled.capacity} slots")
        survivors = {c: pooled.client_cut(c).clone() for c in pooled.active_ids}
        shrunk, ms = timed(pooled.maybe_shrink)
        events["shrink"] = [ms]
        with not_the_path():
            shrunk_v = others["vmapped"].maybe_shrink()
        if shrunk != 8 or shrunk_v != 8:
            raise AssertionError(f"shrink: capacity {shrunk}, not 8")
        for c, cut in survivors.items():
            if not torch.equal(pooled.client_cut(c), cut):
                raise AssertionError(f"client {c}'s cut moved across the shrink")
        agree(pooled, others["vmapped"], "after the shrink")
        # 8: two syncs
        for _ in range(2):
            sync("after the shrink")
        warm8_ms = statistics.median(r["ms"] for r in rows[-2:])
        del others["vmapped"]

        # 9: the scheduler on the real clock, and lockstep on the same motion
        ids = pooled.active_ids
        normals, stragglers = ids[:6], ids[6:]
        paths = {c: np.clip(pooled._slot_cams[pooled._slot_of(c)] + b, lo, hi)
                 for c, b in zip(normals, burst_steps)}
        paths.update(zip(stragglers, strag))
        tight, loose = 3.0 * warm8_ms, 60.0 * warm8_ms
        sched = SCH.DeadlineScheduler(pooled, default_deadline_ms=tight,
                                      tick_budget_ms=2.0 * warm8_ms)
        for c in stragglers:
            sched.set_deadline(c, loose)
        ticks = {"synced": 0, "idle": 0, "drain": 0}

        def tick(what):
            before = K.launch_counts()
            st = sched.tick()
            if st is None:
                return None
            check_kernels(st, before, what)
            ticks["synced"] += 1
            return st

        for t in range(RAGGED_TICKS):
            for i, c in enumerate(ids):
                if deliver[t, i]:
                    sched.observe_motion(c, paths[c][t])
            if tick(f"tick {t}") is None:
                ticks["idle"] += 1
        for _ in range(16):
            if tick("drain") is None:
                break
            ticks["drain"] += 1
        mtp = sched.stats_summary()
        # what a tick adds to its partial sync: the read-only staleness preview
        with not_the_path():
            preview_ms = statistics.median(timed(sched._predicted_pairs)[1]
                                           for _ in range(5))
        deadline = {c: loose if c in stragglers else tight for c in ids}
        oldest, lock, cams = {c: None for c in ids}, [], {c: paths[c][0] for c in ids}
        timed(lambda: pooled.sync(cams))
        for t in range(RAGGED_TICKS):
            now = time.monotonic()
            for i, c in enumerate(ids):
                if deliver[t, i]:
                    cams[c] = paths[c][t]
                    oldest[c] = now if oldest[c] is None else oldest[c]
            if not any(o is not None for o in oldest.values()):
                continue
            before = K.launch_counts()
            st = pooled.sync(cams)
            torch.cuda.synchronize()
            done = time.monotonic()
            check_kernels(st, before, f"lockstep {t}")
            for c in ids:
                if oldest[c] is not None:
                    lock.append(((done - oldest[c]) * 1e3, deadline[c]))
                    oldest[c] = None
        lock_ms = np.asarray([x for x, _d in lock])
        lock_mtp = dict(n=len(lock), mtp_p50_ms=float(np.percentile(lock_ms, 50)),
                        mtp_p99_ms=float(np.percentile(lock_ms, 99)),
                        deadline_miss_rate=float(np.mean([x > d for x, d in lock])))

        # 10: one pooled fallback render of the live clients
        render("after the shrink and the scheduler")
    counts = {name: n - aside[name] for name, n in K.launch_counts().items()}
    if counts["rasterize_slabs"] != len(renders):
        raise AssertionError(f"the ragged fleet's {len(renders)} renders launched K2 "
                             f"{counts['rasterize_slabs']} times")
    # K1 runs only in the vmapped reference service, beside the path
    require_launched("ragged fleet", counts, ("lod_pair_sweep", "vq_assign",
                                              "rasterize_slabs", "bin_tiles"))
    if aside["lod_slab_sweep"] < 1:
        raise AssertionError("the vmapped reference service never launched K1")
    off = [n for key in shapes for n in shapes[key] if n & (n - 1) and n not in caps[key]]
    if off:
        raise AssertionError(f"K5/K6 launch sizes off the pow2 buckets: {off} "
                             f"(caps {caps})")
    # K6 and K5 against their plain versions on the path's own inputs: the
    # largest launch of each and its first launch at a clamp
    checked = []
    for key, label, kern, plain in (
            ("k6_pairs", "K6", lod_cut.lod_pair_sweep, lod_cut.pair_sweep_plain),
            ("k5_rows", "K5", vq_assign.vq_assign, vq_assign.vq_assign_plain)):
        if "largest" not in kept[key]:
            raise AssertionError(f"{key}: no launch on the path")
        for which, (n, a, kw) in kept[key].items():
            got, want = kern(*a, **kw), plain(*a, **kw)
            torch.cuda.synchronize()
            got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
            for i, (x, y) in enumerate(zip(got, want, strict=True)):
                if not torch.equal(x, y):
                    raise AssertionError(f"{label} at its {which} launch ({n}): "
                                         f"output {i} differs from the plain version")
            checked.append(f"{label} {which} {n}")
    log(f"[check] ragged fleet: K6 and K5 == plain on the path's inputs ({', '.join(checked)})")
    del kept

    log(f"[ragged] on {card}: lifecycle ms " + json.dumps(
        {k: [round(x, 3) for x in v] for k, v in events.items()}))
    log(f"[ragged] on {card}: warm sync {warm16_ms:.2f} ms at capacity 16 with 4 slots "
        f"free; {warm8_ms:.2f} ms at capacity 8 after the shrink; the NACK repaid in "
        f"{nack_syncs} syncs; every sync of the script equal to the vmapped service's")
    for t_name, traj in trajectory.items():
        log(f"[ragged] on {card}: tier {t_name} (allowance, τ scale) a sync: "
            f"{[(a, round(s, 4)) for a, s in traj]}")
    log(f"[ragged] on {card}: scheduler {RAGGED_TICKS} ticks ({ticks}), deadline "
        f"{tight:.2f} ms (stragglers {loose:.1f}), budget {2.0 * warm8_ms:.2f} ms: MTP "
        f"p50 {mtp['mtp_p50_ms']:.2f} p99 {mtp['mtp_p99_ms']:.2f} ms, miss rate "
        f"{mtp['deadline_miss_rate']:.3f} (n {mtp['n']}); lockstep on the same motion: "
        f"p50 {lock_mtp['mtp_p50_ms']:.2f} p99 {lock_mtp['mtp_p99_ms']:.2f} ms, miss rate "
        f"{lock_mtp['deadline_miss_rate']:.3f} (n {lock_mtp['n']}); cost model "
        f"{sched.cost.alpha:.3f} + {sched.cost.beta:.5f}·pairs ms; a tick's staleness "
        f"preview {preview_ms:.2f} ms")
    log(f"[ragged] on {card}: distinct launch sizes, K6 pairs "
        f"{sorted(shapes['k6_pairs'])} (pool caps {sorted(caps['k6_pairs'])}), K5 rows "
        f"{sorted(shapes['k5_rows'])} (stream budgets {sorted(caps['k5_rows'])})")
    log(f"[ragged] on {card}: pooled fallback renders " + json.dumps(renders))
    log(f"[ragged] kernels on the path {json.dumps(counts)}; launched beside it by the "
        f"check services, the pair sizing and the reference renders {json.dumps(aside)}")
    return dict(cut_budget=cfg.cut_budget, syncs=rows, lifecycle_ms=events,
                warm16_ms=warm16_ms, warm8_ms=warm8_ms, nack=dict(
                    client=victim, tier=tier(victim), page=page, rows=lost,
                    syncs=nack_syncs, resident=mine),
                trajectory=trajectory, scheduler=dict(
                    ticks=ticks, deadline_ms=tight, straggler_deadline_ms=loose,
                    mtp=mtp, lockstep=lock_mtp, cost=sched.cost.state_dict(),
                    preview_ms=preview_ms),
                shapes={k: sorted(v) for k, v in shapes.items()}, renders=renders,
                checked=checked, aside=aside, counts=counts)


RECOVERY_EVERY = 4           # phase 12: a snapshot every this many syncs
RECOVERY_KEEP = 2            # phase 12: snapshots kept
RECOVERY_AFTER = 4           # phase 12: syncs after the recovery, each held to the twin
RECOVERY_SEED = 12


def fleet_recovery(torch, dev, tree, extent, base, focal, width, height, pair_total,
                   cut_budget, card) -> dict:
    """Phase 12 of the module docstring, on phase 7's scene. Raises on a
    failed check; returns the phase's report, with the launch counts of the
    recovery path under "counts"."""
    import shutil
    import tempfile
    import numpy as np
    from repro_torch import kernels as K
    from repro_torch import pytree
    from repro_torch import render as R
    from repro_torch.checkpoint import manager as CK
    from repro_torch.core import camera as C
    from repro_torch.core import compression as CP
    from repro_torch.core import pipeline as P
    from repro_torch.kernels import lod_cut, vq_assign
    from repro_torch.serve import lod_service as SV
    from repro_torch.serve import recovery as REC

    K.reset_launch_counts()
    w, (ex, ey) = base.w, extent
    rng = np.random.default_rng(RECOVERY_SEED)
    n_frames = (8 + RECOVERY_AFTER) * w + 1
    walks = [np.stack([cam.pos.numpy() for cam in C.walk_trajectory(
        C.TrajectoryConfig(seed=c), n_frames, extent, focal_px=focal, width=width,
        height=height, device="cpu")]).astype(np.float32) for c in range(RAGGED_START + 4)]
    centre = np.asarray([ex / 2, ey / 2, 1.7], np.float32)

    def tier(c):
        return RAGGED_TIERS[c % 3]

    def tau(c):
        return 48.0 if c % 2 == 0 else 84.0

    cfg = P.SessionConfig(tau=48.0, w=w, w_star=32, cut_budget=cut_budget)
    directory = tempfile.mkdtemp(prefix="nebula_recovery_")
    free_gb = shutil.disk_usage(directory).free / 2**30
    log(f"[recovery] snapshots under {directory} ({free_gb:.1f} GiB free); every "
        f"{RECOVERY_EVERY} syncs, keep {RECOVERY_KEEP}; {RAGGED_START} clients at capacity "
        f"{RAGGED_START}, max_clients {RAGGED_MAX}, cut_budget {cut_budget}")

    aside = dict.fromkeys(K.launch_counts(), 0)
    checking, replaying = [False], [False]

    @contextlib.contextmanager
    def not_the_path():
        before = K.launch_counts()
        checking[0] = True
        try:
            yield
        finally:
            checking[0] = False
            for name, n in K.launch_counts().items():
                aside[name] += n - before[name]

    # the replays' K6 and K5 launches: sizes, and the arguments of the largest
    replayed_at = {"k6_pairs": [], "k5_rows": []}
    kept = {}

    def recorder(key, fn):
        def run(*a, **kw):
            if replaying[0] and not checking[0]:
                n = int(a[0].shape[0])
                replayed_at[key].append(n)
                if n > kept.get(key, (0,))[0]:
                    kept[key] = (n, a, kw)
            return fn(*a, **kw)
        return run

    spans = StageTimer(torch)
    real_replay, real_snapshot = REC.replay, REC.snapshot_service
    snapshots = []

    def snapshot(service, directory_, *a, **kw):
        path = spans.wrap("snapshot", real_snapshot)(service, directory_, *a, **kw)
        nbytes = sum(f.stat().st_size for f in Path(path).iterdir())
        snapshots.append(dict(step=int(Path(path).name.split("_")[1]),
                              capacity=service.capacity, ms=spans.take("snapshot"),
                              host_copy_ms=spans.take("host_copy"),
                              write_ms=spans.take("write"),
                              fingerprint_ms=spans.take("fingerprint"), bytes=nbytes))
        return path

    def replay(service, records):
        replaying[0] = True
        try:
            return spans.wrap("replay", real_replay)(service, records)
        finally:
            replaying[0] = False

    def restore_spans():
        """ms of a recovery's parts: the fresh service, the tree's
        fingerprint, the leaf files' read, the copy to the card, the replay
        (a snapshot that fails to restore adds its part to each)."""
        return {f"{k}_ms": spans.take(k)
                for k in ("service", "fingerprint", "read", "to_card", "replay")}

    def spans_text(d):
        return ", ".join(f"{k[:-3]} {d[k]:.1f}" for k in (
            "service_ms", "fingerprint_ms", "read_ms", "to_card_ms", "replay_ms"))

    def state_of(svc):
        out = {key: leaf for key, leaf in pytree.flatten_with_paths(svc.state)}
        for name in ("_active", "_client_ids", "_slot_cams", "_delta_ids", "_bw_target",
                     "_allowance", "_tau_scale", "_stats_fresh"):
            out[name] = torch.from_numpy(np.array(getattr(svc, name)))
        out["next_id"] = torch.tensor(svc._next_id)
        out["taus"] = None if svc.taus is None else torch.from_numpy(svc.taus.copy())
        out["last_sync_bytes"] = (None if svc._last_stats is None
                                  else svc._last_stats.sync_bytes)
        return out

    def same(a, b, what, sa=None, sb=None):
        """Every state leaf, host mirror and stats column of `a` equal to
        `b`'s bit for bit, dtypes included."""
        pairs = list(zip(state_of(a).items(), state_of(b).items(), strict=True))
        if sa is not None:
            pairs += [((f.name, getattr(sa, f.name)), (f.name, getattr(sb, f.name)))
                      for f in dataclasses.fields(sa)]
        for (ka, x), (kb, y) in pairs:
            if ka != kb or (x is None) != (y is None):
                raise AssertionError(f"{what}: {ka} / {kb} differ in kind")
            if x is not None and (x.dtype != y.dtype or not torch.equal(x, y)):
                raise AssertionError(f"{what}: {ka} differs from the twin's")
        if a.capacity != b.capacity or a.active_ids != b.active_ids:
            raise AssertionError(f"{what}: fleets differ")
        for key, leaf in pytree.flatten_with_paths(a.state):
            if leaf.device.type != dev.type:
                raise AssertionError(f"{what}: leaf {key} is on {leaf.device}")

    with not_the_path():
        twin = SV.LodService(tree, cfg, RAGGED_START, focal=focal, mode="vmapped",
                             taus=[tau(c) for c in range(RAGGED_START)],
                             capacity=RAGGED_START, max_clients=RAGGED_MAX,
                             bandwidth=[tier(c) for c in range(RAGGED_START)])
    syncs, t_walk = [], [0]

    def both(op, *args):
        out = getattr(mgr, op)(*args)
        with not_the_path():
            if getattr(twin, op)(*args) != out:
                raise AssertionError(f"{op}{args}: the service and its twin disagree")
        return out

    def sync(what, ops):
        t = t_walk[0]
        t_walk[0] += 1
        svc = ops.service if hasattr(ops, "service") else ops
        cams = {c: walks[c][t * w] for c in svc.active_ids}
        n_snap = len(snapshots)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = ops.sync(cams)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        with not_the_path():
            st_twin = twin.sync(cams)
        same(svc, twin, what, st, st_twin)
        if bool(st.overflow.any()):
            raise AssertionError(f"{what}: a cut overflowed {cfg.cut_budget}")
        syncs.append(dict(what=what, ms=ms, capacity=svc.capacity, live=svc.n_clients,
                          snapshot=len(snapshots) > n_snap))
        log(f"[recovery sync {t}] on {card}: {what}: {ms:.2f} ms, {svc.n_clients} live in "
            f"{svc.capacity} slots{' (took a snapshot)' if len(snapshots) > n_snap else ''}; "
            f"equal to the twin")
        return st

    events = {}
    try:
        with contextlib.ExitStack() as patches:
            for obj, name, fn in (
                    (SV, "lod_pair_sweep", recorder("k6_pairs", SV.lod_pair_sweep)),
                    (CP, "vq_assign", recorder("k5_rows", CP.vq_assign)),
                    (CK, "host_items", spans.wrap("host_copy", CK.host_items)),
                    (CK, "write_items", spans.wrap("write", CK.write_items)),
                    (CK, "load_leaves", spans.wrap("read", CK.load_leaves)),
                    (CK, "place", spans.wrap("to_card", CK.place)),
                    (REC, "LodService", spans.wrap("service", REC.LodService)),
                    (REC, "tree_fingerprint", spans.wrap("fingerprint", REC.tree_fingerprint)),
                    (REC, "snapshot_service", snapshot), (REC, "replay", replay)):
                patches.enter_context(mock.patch.object(obj, name, fn))
            service = SV.LodService(tree, cfg, RAGGED_START, focal=focal, mode="pooled",
                                    taus=[tau(c) for c in range(RAGGED_START)],
                                    capacity=RAGGED_START, max_clients=RAGGED_MAX,
                                    bandwidth=[tier(c) for c in range(RAGGED_START)])
            twin.codec = service.codec
            mgr = REC.RecoveryManager(service, directory, every=RECOVERY_EVERY,
                                      keep=RECOVERY_KEEP)
            same(service, twin, "the base snapshot")
            # the script: 2 syncs, 4 admits (8 -> 16 slots), a re-tier, 3
            # syncs, 2 evicts, a seeded lost page and its NACK, 2 syncs
            for _ in range(2):
                sync("start", mgr)
            for _ in range(4):
                c = service._next_id
                both("admit", walks[c][t_walk[0] * w], tau(c), True, tier(c))
            if service.capacity != 16:
                raise AssertionError(f"capacity {service.capacity} after the admits, not 16")
            both("set_bandwidth", 1, "tethered")
            for _ in range(3):
                sync("after the admits", mgr)
            for c in (3, 9):
                both("evict", c)
            batch = service.last_delta
            took = batch.ref_mask.sum(1).cpu().numpy()
            cands = [c for c in service.active_ids
                     if service._delta_ids[service._slot_of(c)] == c
                     and took[service._slot_of(c)] > 0]
            victim = int(rng.choice(cands))
            rp = batch.row_page.cpu().numpy()
            vmask = batch.ref_mask[service._slot_of(victim)].cpu().numpy()
            page = int(rng.choice(np.unique(rp[vmask & (rp >= 0)])))
            lost = both("nack", victim, [page])
            if lost <= 0:
                raise AssertionError(f"the NACK of page {page} of client {victim} "
                                     f"re-queued nothing")
            log(f"[recovery] client {victim} lost page {page}: {lost} rows re-queued")
            for _ in range(2):
                sync("after the NACK", mgr)
            head = mgr.journal.seq
            snap_dir = mgr.snapshot_dir
            newest = CK.latest_step(snap_dir)
            tail = [r["kind"] for r in REC.SyncJournal.read(mgr.journal.path)[newest:]]
            if "sync" not in tail or "nack" not in tail:
                raise AssertionError(f"the journal's tail after step {newest} is {tail}")

            # the crash: every reference dropped, a torn last record
            del mgr, service, batch
            gc.collect()
            torch.cuda.empty_cache()
            with open(os.path.join(directory, REC.JOURNAL_NAME), "a") as f:
                f.write('{"cams": {"0": [1.5, ')
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mgr, replayed = REC.recover(tree, directory, every=RECOVERY_EVERY,
                                        keep=RECOVERY_KEEP)
            torch.cuda.synchronize()
            recover_ms = (time.perf_counter() - t0) * 1e3
            service = mgr.service
            first = dict(step=newest, records=replayed, tail=tail, total_ms=recover_ms,
                         **restore_spans())
            if replayed != head - newest or mgr.journal.seq != head:
                raise AssertionError(f"recovered {replayed} records from step {newest}, "
                                     f"journal head {mgr.journal.seq} (want {head})")
            same(service, twin, "right after the recovery")
            log(f"[recovery] on {card}: recovered from step {newest} in {recover_ms:.1f} ms: "
                f"{spans_text(first)}; {replayed} records {tail}; equal to the twin bit "
                f"for bit")
            for k in range(RECOVERY_AFTER):
                sync(f"after the recovery ({k})", mgr)

            # one pooled fallback render of each
            ids = service.active_ids
            rigs = []
            for c in ids:
                pos = service._slot_cams[service._slot_of(c)]
                target = (centre if np.linalg.norm(centre[:2] - pos[:2]) > 1.0
                          else pos + [10, 10, 0])
                rigs.append(C.StereoRig(left=C.make_camera(
                    pos, target, focal_px=focal, width=width, height=height, near=0.25,
                    device=dev), baseline=0.06))
            with not_the_path():
                rc = R.RenderConfig.for_fleet(rigs, tile=base.tile, list_len=base.list_len)
                max_pairs = pow2_at_least(max(
                    pair_total(SV._masked_queue(tree.gaussians, service.client_cut(c)), r, rc)
                    for c, r in zip(ids, rigs)))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fl, fr, fst = service.render_fallback(rigs, list_len=base.list_len,
                                                  max_pairs=max_pairs, path="pooled")
            torch.cuda.synchronize()
            render_ms = (time.perf_counter() - t0) * 1e3
            with not_the_path():
                tl, tr, tst = twin.render_fallback(rigs, list_len=base.list_len,
                                                   max_pairs=max_pairs, path="pooled")
                torch.cuda.synchronize()
            live = torch.as_tensor(service._active, device=dev)
            if bool(fl[~live].any()) or bool(fr[~live].any()):
                raise AssertionError("a free slot's frame is not black")
            if not (torch.equal(fl, tl) and torch.equal(fr, tr)) or not all(
                    torch.equal(getattr(fst, f.name), getattr(tst, f.name))
                    for f in dataclasses.fields(fst)):
                raise AssertionError("the recovered fleet's render differs from the twin's")
            if bool((fl[live].flatten(1).amax(1) <= 0).all()):
                raise AssertionError("every live client's frame is blank")
            log(f"[recovery] on {card}: pooled render of {len(ids)} clients in "
                f"{service.capacity} slots {render_ms:.1f} ms, equal to the twin's bit for "
                f"bit, free slots black")
            del fl, fr, fst, tl, tr, tst

            # the fault leg: a truncated leaf file in the newest snapshot
            head = mgr.journal.seq
            steps = CK.valid_steps(snap_dir)
            bad_dir = Path(snap_dir) / f"step_{steps[0]:08d}"
            leaf = sorted(bad_dir.glob("leaf_*.npy"))[0]
            leaf.write_bytes(leaf.read_bytes()[: max(1, leaf.stat().st_size // 2)])
            del mgr, service
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mgr, replayed2 = REC.recover(tree, directory, every=RECOVERY_EVERY,
                                         keep=RECOVERY_KEEP)
            torch.cuda.synchronize()
            fallback_ms = (time.perf_counter() - t0) * 1e3
            fallback = dict(bad_step=steps[0], step=steps[1], records=replayed2,
                            total_ms=fallback_ms, **restore_spans())
            if replayed2 != head - steps[1]:
                raise AssertionError(f"the fallback replayed {replayed2} records, not "
                                     f"{head - steps[1]} from step {steps[1]}")
            same(mgr.service, twin, "after the fallback to an earlier snapshot")
            log(f"[recovery] on {card}: step {steps[0]} truncated: fell back to step "
                f"{steps[1]} in {fallback_ms:.1f} ms ({spans_text(fallback)}; {replayed2} "
                f"records); equal to the twin bit for bit")
            del mgr
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    counts = {name: n - aside[name] for name, n in K.launch_counts().items()}
    require_launched("recovery", counts, ("lod_pair_sweep", "vq_assign", "rasterize_slabs",
                                          "preprocess", "stereo_merge", "bin_tiles"))
    if not (replayed_at["k6_pairs"] and replayed_at["k5_rows"]):
        raise AssertionError(f"K6 or K5 never launched in a replay: {replayed_at}")
    if aside["lod_slab_sweep"] < 1:
        raise AssertionError("the vmapped twin never launched K1")
    checked = []
    for key, label, kern, plain in (
            ("k6_pairs", "K6", lod_cut.lod_pair_sweep, lod_cut.pair_sweep_plain),
            ("k5_rows", "K5", vq_assign.vq_assign, vq_assign.vq_assign_plain)):
        n, a, kw = kept.pop(key)
        got, want = kern(*a, **kw), plain(*a, **kw)
        torch.cuda.synchronize()
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        for i, (x, y) in enumerate(zip(got, want, strict=True)):
            if not torch.equal(x, y):
                raise AssertionError(f"{label} at the replays' largest launch ({n}): "
                                     f"output {i} differs from the plain version")
        checked.append(f"{label} {n}")
    log(f"[check] recovery: K6 and K5 == plain at the replays' largest launches "
        f"({', '.join(checked)}); replay launch sizes {json.dumps(replayed_at)}")
    snap_ms = [x["ms"] for x in snapshots]
    plain_sync = [x["ms"] for x in syncs if not x["snapshot"] and x["capacity"] == 16]
    snap_sync = [x["ms"] for x in syncs if x["snapshot"]]
    log(f"[recovery] on {card}: snapshots " + json.dumps(
        [{k: (round(v, 3) if isinstance(v, float) else v) for k, v in x.items()}
         for x in snapshots]))
    log(f"[recovery] on {card}: a sync that snapshots {[round(x, 2) for x in snap_sync]} "
        f"ms, one that does not "
        f"(capacity 16) {[round(x, 2) for x in plain_sync]} ms; snapshot total "
        f"{[round(x, 1) for x in snap_ms]} ms")
    log(f"[recovery] kernels on the path {json.dumps(counts)}; launched beside it by the "
        f"twin, the pair sizing and the twin's render {json.dumps(aside)}")
    return dict(snapshots=snapshots, syncs=syncs, recover=first, fallback=fallback,
                render_ms=render_ms, nack=dict(client=victim, page=page, rows=lost),
                replay_launches=replayed_at, checked=checked, aside=aside, counts=counts)


MESH_SEED = 13
MESH_RANKS = (2, 2)          # phase 13 (b): clients x slabs, four ranks on the one card
MESH_CAPACITY = 16           # (b): slots, 8 a client shard
MESH_SYNCS = 6               # (b): syncs; an admit before the third, an evict before the fifth
MESH_TICKS = 6               # (a): deadline-scheduler ticks, each a partial sync
MESH_VMAPPED_SYNCS = 3       # (a): syncs of the vmapped scheduler on the mesh and off it
MESH_WAIT_S = 400            # the longest the parent waits on a rank, or a rank on the parent


class ScriptedClock:
    """A monotonic clock that moves 1 ms a read: two schedulers given one
    each take the same decisions."""

    def __init__(self, t0: float = 100.0):
        self.t = float(t0)

    def __call__(self) -> float:
        self.t += 1e-3
        return self.t


def mesh_walks(np, C, extent, focal, width, height, n_frames: int):
    """Seeded walks of phase 13's clients (four more than it starts with, for
    the admits), as (clients, n_frames, 3) float32 positions."""
    return np.stack([np.stack([cam.pos.numpy() for cam in C.walk_trajectory(
        C.TrajectoryConfig(seed=MESH_SEED + c), n_frames, extent, focal_px=focal,
        width=width, height=height, device="cpu")]) for c in range(RAGGED_START + 4)]
    ).astype(np.float32)


def mesh_service(SV, tree, cfg, focal, mesh, capacity, mode="pooled"):
    """Phase 13's fleet: phase 11's 8 clients (the three tiers, foveated τ,
    max_clients 16) in `capacity` slots, on `mesh` (None: meshless)."""
    return SV.LodService(tree, cfg, RAGGED_START, focal=focal, mode=mode,
                         taus=[48.0 if c % 2 == 0 else 84.0 for c in range(RAGGED_START)],
                         capacity=capacity, max_clients=RAGGED_MAX,
                         bandwidth=[RAGGED_TIERS[c % 3] for c in range(RAGGED_START)],
                         mesh=mesh)


def delta_digests(torch, svc, hashed: bool = True) -> dict:
    """{client: sha256 of its slice of the latest encode-once payload,
    decoded} for every live client: its union ids and every decoded row
    (`client_delta`, which gathers a meshed payload's split rows; every rank
    of a mesh calls it, and a rank that does not report passes `hashed`
    False)."""
    import hashlib
    from repro_torch import pytree
    out = {}
    for c in svc.active_ids:
        ids, dec = svc.client_delta(c)
        if not hashed:
            continue
        h = hashlib.sha256(ids.contiguous().cpu().numpy().tobytes())
        for x in pytree.leaves(dec):
            h.update(x.contiguous().cpu().numpy().tobytes())
        out[str(c)] = h.hexdigest()
    if svc.mesh is not None:
        # the ranks enter the next sync together, so the reporting rank's
        # hashing is not timed as the others' wait in a collective
        torch.distributed.barrier()
    return out


def mesh_script(torch, svc, walks, w, hashed: bool = True):
    """Phase 13 (b)'s script on one service (every rank of a mesh runs it):
    MESH_SYNCS syncs on the walks, client 8 admitted before the third and
    client 3 evicted before the fifth. Returns each sync's whole-fleet stats
    on the host, its ms and the digests of its decoded Δ slices
    (`delta_digests`), and the last sync's stats as returned."""
    from repro_torch import pytree
    rows, ms, digests = [], [], []
    for k in range(MESH_SYNCS):
        if k == 2:
            svc.admit(walks[RAGGED_START][k * w], 48.0, True, RAGGED_TIERS[RAGGED_START % 3])
        if k == 4:
            svc.evict(3)
        cams = {c: walks[c][k * w] for c in svc.active_ids}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = svc.sync(cams)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        rows.append(pytree.tree_map(lambda x: x.cpu(), svc.gather_slots(st)))
        digests.append(delta_digests(torch, svc, hashed))
    return rows, ms, digests, st


def mesh_rigs(C, svc, extent, focal, width, height, dev):
    """A rig for each live client, looking at the city's centre from where
    the service last synced it."""
    import numpy as np
    centre = np.asarray([extent[0] / 2, extent[1] / 2, 1.7], np.float32)
    rigs = []
    for c in svc.active_ids:
        pos = svc._slot_cams[svc._slot_of(c)]
        target = centre if np.linalg.norm(centre[:2] - pos[:2]) > 1.0 else pos + [10, 10, 0]
        rigs.append(C.StereoRig(left=C.make_camera(pos, target, focal_px=focal, width=width,
                                                   height=height, near=0.25, device=dev),
                                baseline=0.06))
    return rigs


def frame_digests(torch, img_l, img_r, lo: int) -> dict:
    """{slot: sha256 of its left and right frames' bytes} of a block of
    frames whose first slot is `lo`."""
    import hashlib
    out = {}
    for i in range(img_l.shape[0]):
        h = hashlib.sha256(img_l[i].contiguous().cpu().numpy().tobytes())
        h.update(img_r[i].contiguous().cpu().numpy().tobytes())
        out[str(lo + i)] = h.hexdigest()
    return out


def _wait_for(path: Path, what: str) -> None:
    t0 = time.perf_counter()
    while not path.exists():
        if time.perf_counter() - t0 > MESH_WAIT_S:
            raise TimeoutError(f"no {what} after {MESH_WAIT_S} s")
        time.sleep(0.05)


def mesh_rank_main(rank: int, workdir: str) -> int:
    """One rank of phase 13 (b), started by the parent as `chip_smoke.py
    --mesh-rank R --mesh-dir D`: joins the gloo group of the four ranks, loads
    phase 7's tree and the codec the parent wrote, builds the 2x2-meshed
    service, waits for the parent's go (the render's pair budget), runs
    `mesh_script` and a pooled render with its launch counters set to 0 and
    its collectives timed, holds K6 and K5 at their largest launches on
    this rank (its pairs, its split of the union's rows) against their
    plain versions, then takes a snapshot. Writes its report (and rank 0
    the whole fleet's stats, Δ digests and totals) under D."""
    import numpy as np
    import torch
    from repro_torch import kernels as K
    from repro_torch.core import camera as C
    from repro_torch.core import compression as CP
    from repro_torch.core import pipeline as P
    from repro_torch.kernels import lod_cut, vq_assign
    from repro_torch.launch.mesh import destroy_fleet_group, init_fleet_group, make_fleet_mesh
    from repro_torch.serve import lod_service as SV
    from repro_torch.sharding import fleet as SH

    d = Path(workdir)
    setup = json.loads((d / "setup.json").read_text())
    dev = torch.device(setup["device"])
    init_fleet_group(str(d / "store"), rank, MESH_RANKS[0] * MESH_RANKS[1], "gloo",
                     device=dev)
    try:
        mesh = make_fleet_mesh(*MESH_RANKS, device=dev)
        tree = torch.load(d / "tree.pt", map_location=dev, weights_only=False)
        codec = torch.load(d / "codec.pt", map_location=dev, weights_only=False)
        walks = np.load(d / "walks.npy")
        cfg = P.SessionConfig(**setup["cfg"])
        svc = mesh_service(SV, tree, cfg, setup["focal"], mesh, MESH_CAPACITY)
        svc.codec = codec
        (d / f"ready_{rank}").write_text("")
        _wait_for(d / "go.json", "go from the parent")
        go = json.loads((d / "go.json").read_text())
        coll = []
        kept = {}

        def recorder(key, fn):
            def run(*a, **kw):
                n = int(a[0].shape[0])
                if n > kept.get(key, (0,))[0]:
                    kept[key] = (n, a, kw)
                return fn(*a, **kw)
            return run

        def timed(fn):
            def run(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                coll.append((time.perf_counter() - t0) * 1e3)
                return out
            return run

        with mock.patch.object(SH, "all_gather_blocks", timed(SH.all_gather_blocks)), \
                mock.patch.object(SH, "all_reduce", timed(SH.all_reduce)), \
                mock.patch.object(SV, "lod_pair_sweep", recorder("K6", SV.lod_pair_sweep)), \
                mock.patch.object(CP, "vq_assign", recorder("K5", CP.vq_assign)):
            per_sync, n_coll = [], [0]
            real_sync = svc.sync

            def sync(*a, **kw):
                before, calls = sum(coll), len(coll)
                out = real_sync(*a, **kw)
                per_sync.append(sum(coll) - before)
                n_coll[0] += len(coll) - calls
                return out

            svc.sync = sync
            K.reset_launch_counts()
            rows, ms, deltas, last = mesh_script(torch, svc, walks, setup["w"],
                                                 hashed=rank == 0)
            rigs = mesh_rigs(C, svc, setup["extent"], setup["focal"], setup["width"],
                             setup["height"], dev)
            lo, hi = svc.slot_block()
            # every rank renders its client shard's slots (the slabs ranks of
            # one shard repeat it), in turn: four renders at once would not
            # fit the card's memory beside the parent's
            for turn in range(MESH_RANKS[0] * MESH_RANKS[1]):
                if turn == rank:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fl, fr, _fst = svc.render_fallback(rigs, list_len=setup["list_len"],
                                                       max_pairs=go["max_pairs"],
                                                       path="pooled")
                    torch.cuda.synchronize()
                    render_ms = (time.perf_counter() - t0) * 1e3
                    digests = frame_digests(torch, fl, fr, lo)
                    del fl, fr, _fst
                    gc.collect()
                    torch.cuda.empty_cache()
                torch.distributed.barrier()
            counts = K.launch_counts()
        checked = {}
        for key, kern, plain in (("K6", lod_cut.lod_pair_sweep, lod_cut.pair_sweep_plain),
                                 ("K5", vq_assign.vq_assign, vq_assign.vq_assign_plain)):
            n, a, kw = kept.pop(key)
            got, want = kern(*a, **kw), plain(*a, **kw)
            torch.cuda.synchronize()
            got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
            for i, (x, y) in enumerate(zip(got, want, strict=True)):
                if not torch.equal(x, y):
                    raise AssertionError(f"rank {rank}: {key} at its largest launch ({n}): "
                                         f"output {i} differs from the plain version")
            checked[key] = n
        del kept
        totals = SH.fleet_totals(last, mesh, capacity=svc.capacity)
        resident = SH.shard_resident_bytes(mesh, svc.tree, svc.state, svc.tables)
        allocated = torch.cuda.memory_allocated()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svc.snapshot(str(d / "snap"))
        snapshot_ms = (time.perf_counter() - t0) * 1e3
        report = dict(rank=rank, coords=list(mesh.coords), sync_ms=ms,
                      collective_ms=per_sync, collective_calls=n_coll[0], render_ms=render_ms,
                      snapshot_ms=snapshot_ms, counts=counts, resident_bytes=resident,
                      allocated_bytes=allocated, slots=[lo, hi], digests=digests,
                      checked=checked)
        if rank == 0:
            from repro_torch import pytree
            torch.save({"rows": rows, "deltas": deltas,
                        "totals": pytree.tree_map(lambda x: x.cpu(), totals)},
                       d / "results.pt")
        (d / f"rank_{rank}.json").write_text(json.dumps(report))
    finally:
        destroy_fleet_group()
    return 0


def _service_state(torch, svc, delta: bool) -> dict:
    """Every state leaf and host mirror of a service, by name, and with
    `delta` every leaf of the latest encode-once payload."""
    import numpy as np
    from repro_torch import pytree
    out = {key: leaf for key, leaf in pytree.flatten_with_paths(svc.state)}
    if delta:
        ld = svc.last_delta
        out["last_delta"] = None if ld is None else torch.tensor(ld.payload_shards)
        out.update({f"last_delta{key}": leaf for key, leaf in
                    ([] if ld is None else pytree.flatten_with_paths(ld))})
    for name in ("_active", "_client_ids", "_slot_cams", "_delta_ids", "_bw_target",
                 "_allowance", "_tau_scale", "_stats_fresh"):
        out[name] = torch.from_numpy(np.array(getattr(svc, name)))
    out["next_id"] = torch.tensor(svc._next_id)
    out["last_sync_bytes"] = (None if svc._last_stats is None
                              else svc._last_stats.sync_bytes.cpu())
    return out


def same_service(torch, a, b, what, sa=None, sb=None, delta=True) -> None:
    """Raise unless services `a` and `b` (and stats `sa`, `sb`) agree bit for
    bit: every state leaf and host mirror, every stats column and, with
    `delta`, every leaf of the latest payload (a restored service has none),
    dtypes included."""
    state_a, state_b = _service_state(torch, a, delta), _service_state(torch, b, delta)
    if list(state_a) != list(state_b):
        raise AssertionError(f"{what}: the services hold different leaves")
    pairs = list(zip(state_a.items(), state_b.items()))
    if sa is not None:
        pairs += [((f.name, getattr(sa, f.name)), (f.name, getattr(sb, f.name)))
                  for f in dataclasses.fields(sa)]
    for (ka, x), (kb, y) in pairs:
        if ka != kb or (x is None) != (y is None):
            raise AssertionError(f"{what}: {ka} / {kb} differ in kind")
        if x is not None and (x.dtype != y.dtype or not torch.equal(x.cpu(), y.cpu())):
            raise AssertionError(f"{what}: {ka} differs from the meshless service's")
    if a.capacity != b.capacity or a.active_ids != b.active_ids:
        raise AssertionError(f"{what}: the fleets differ")


def fleet_mesh(torch, dev, tree, extent, base, focal, width, height, pair_total,
               cut_budget, card) -> dict:
    """Phase 13 of the module docstring, on phase 7's scene. Raises on a
    failed check; returns the phase's report, with the launch counts of the
    meshed services (in this process and on the four ranks) under
    "counts"."""
    import shutil
    import tempfile
    import numpy as np
    from repro_torch import kernels as K
    from repro_torch import render as R
    from repro_torch.core import camera as C
    from repro_torch.core import pipeline as P
    from repro_torch.checkpoint import manager as CK
    from repro_torch.launch.mesh import destroy_fleet_group, init_fleet_group, make_fleet_mesh
    from repro_torch.serve import lod_service as SV
    from repro_torch.serve import recovery as REC
    from repro_torch.serve import scheduler as SCH
    from repro_torch.sharding import fleet as SH

    K.reset_launch_counts()
    w = base.w
    cfg = P.SessionConfig(tau=48.0, w=w, w_star=32, cut_budget=cut_budget)
    walks = mesh_walks(np, C, extent, focal, width, height, 16 * w + 1)
    n_ranks = MESH_RANKS[0] * MESH_RANKS[1]
    aside = dict.fromkeys(K.launch_counts(), 0)

    @contextlib.contextmanager
    def not_the_path():
        before = K.launch_counts()
        try:
            yield
        finally:
            for name, n in K.launch_counts().items():
                aside[name] += n - before[name]

    def max_pairs_of(svc, rigs):
        rc = R.RenderConfig.for_fleet(rigs, tile=base.tile, list_len=base.list_len)
        return pow2_at_least(max(
            pair_total(SV._masked_queue(tree.gaussians, svc.client_cut(c)), r, rc)
            for c, r in zip(svc.active_ids, rigs)))

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    d = Path(tempfile.mkdtemp(prefix="nebula_mesh_"))
    procs = []
    report = {}
    try:
        # (b)'s ranks start first: they load the tree and build their
        # services while this process runs (a), then wait for the go
        with not_the_path():
            twin_b = mesh_service(SV, tree, cfg, focal, None, MESH_CAPACITY)
        t0 = time.perf_counter()
        torch.save(tree, d / "tree.pt")
        torch.save(twin_b.codec, d / "codec.pt")
        np.save(d / "walks.npy", walks)
        (d / "setup.json").write_text(json.dumps(dict(
            cfg=dataclasses.asdict(cfg), focal=focal, w=w, extent=list(extent), width=width,
            height=height, list_len=base.list_len, device=str(dev))))
        write_ms = (time.perf_counter() - t0) * 1e3
        for r in range(n_ranks):
            with open(d / f"rank_{r}.log", "w") as out:
                procs.append(subprocess.Popen(
                    [sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-rank", str(r),
                     "--mesh-dir", str(d)], stdout=out, stderr=subprocess.STDOUT))

        def ranks_wait(paths, what):
            t_start = time.perf_counter()
            while not all(p.exists() for p in paths):
                for r, pr in enumerate(procs):
                    if pr.poll() not in (None, 0):
                        tail = (d / f"rank_{r}.log").read_text()[-3000:]
                        raise AssertionError(f"rank {r} exited {pr.returncode} before "
                                             f"{what}:\n{tail}")
                if time.perf_counter() - t_start > MESH_WAIT_S:
                    raise TimeoutError(f"ranks not at {what} after {MESH_WAIT_S} s")
                time.sleep(0.05)
            return (time.perf_counter() - t_start) * 1e3

        ready_ms = ranks_wait([d / f"ready_{r}" for r in range(n_ranks)], "ready")
        log(f"[mesh] {n_ranks} gloo ranks ready on {card} ({ready_ms:.0f} ms after the "
            f"parent wrote the tree in {write_ms:.0f} ms)")

        # (a) a 1x1 mesh in this process (NCCL, world size 1) -----------------
        init_fleet_group(str(d / "store_a"), 0, 1, "nccl", device=dev)
        try:
            mesh = make_fleet_mesh(1, 1, device=dev)
            meshed = mesh_service(SV, tree, cfg, focal, mesh, RAGGED_START)
            with not_the_path():
                twin = mesh_service(SV, tree, cfg, focal, None, RAGGED_START)
            twin.codec = meshed.codec
            rows, t_walk = [], [0]

            def both(op, *args):
                out = getattr(meshed, op)(*args)
                with not_the_path():
                    if getattr(twin, op)(*args) != out:
                        raise AssertionError(f"(a) {op}{args}: meshed and meshless disagree")
                return out

            def sync(what):
                t = t_walk[0]
                t_walk[0] += 1
                cams = {c: walks[c][t * w] for c in meshed.active_ids}
                sm, ms_m = timed(lambda: meshed.sync(cams))
                with not_the_path():
                    st, ms_t = timed(lambda: twin.sync(cams))
                same_service(torch, meshed, twin, f"(a) {what}", sm, st)
                rows.append(dict(what=what, capacity=meshed.capacity, live=meshed.n_clients,
                                 meshed_ms=ms_m, meshless_ms=ms_t))
                return sm

            for _ in range(2):
                sync("start")
            for c in range(RAGGED_START, RAGGED_START + 4):
                both("admit", walks[c][t_walk[0] * w], 48.0 if c % 2 == 0 else 84.0, True,
                     RAGGED_TIERS[c % 3])
            if meshed.capacity != 16:
                raise AssertionError(f"(a) capacity {meshed.capacity} after the admits")
            for _ in range(2):
                sync("capacity 16")
            for c in (2, 5, 9):
                both("evict", c)
            sync("after the evicts")
            batch = meshed.last_delta
            took = batch.ref_mask.sum(1).cpu().numpy()
            rng = np.random.default_rng(MESH_SEED)
            victim = int(rng.choice([c for c in meshed.active_ids
                                     if took[meshed._slot_of(c)] > 0]))
            rp = batch.row_page.cpu().numpy()
            vmask = batch.ref_mask[meshed._slot_of(victim)].cpu().numpy()
            page = int(rng.choice(np.unique(rp[vmask & (rp >= 0)])))
            lost = both("nack", victim, [page])
            if lost <= 0:
                raise AssertionError(f"(a) the NACK of page {page} re-queued nothing")
            sync("after the NACK")
            scheds = [SCH.DeadlineScheduler(svc, default_deadline_ms=42.0, tick_budget_ms=3.0,
                                            clock=ScriptedClock()) for svc in (meshed, twin)]
            for sch in scheds:
                sch.cost.alpha, sch.cost.beta = 0.5, 0.25
            partial = 0
            for k in range(MESH_TICKS):
                t = t_walk[0] + k
                for c in meshed.active_ids:
                    if rng.random() < 0.7:
                        for sch in scheds:
                            sch.observe_motion(c, walks[c][t * w])
                picks = [sch.select() for sch in scheds]
                if picks[0] != picks[1]:
                    raise AssertionError(f"(a) tick {k}: the schedulers select {picks}")
                sm, ms_m = timed(scheds[0].tick)
                with not_the_path():
                    st = scheds[1].tick()
                if (sm is None) != (st is None):
                    raise AssertionError(f"(a) tick {k}: one scheduler idled")
                if sm is not None:
                    same_service(torch, meshed, twin, f"(a) tick {k}", sm, st)
                    partial += int(len(picks[0]) < meshed.n_clients)
                rows.append(dict(what=f"tick {k}", selected=len(picks[0]),
                                 live=meshed.n_clients, meshed_ms=ms_m))
            t_walk[0] += MESH_TICKS
            if partial < 1:
                raise AssertionError("(a) no tick was a partial sync")
            both("evict", 10)
            if both("maybe_shrink") != 8:
                raise AssertionError("(a) the shrink did not come to 8 slots")
            sync("after the shrink")
            meshed.resize_mesh(None)
            sync("moved off the mesh")
            meshed.resize_mesh(mesh)
            sync("moved back onto the mesh")
            rigs = mesh_rigs(C, meshed, extent, focal, width, height, dev)
            with not_the_path():
                max_pairs = max_pairs_of(meshed, rigs)
            (fl, fr, fst), render_ms = timed(lambda: meshed.render_fallback(
                rigs, list_len=base.list_len, max_pairs=max_pairs, path="pooled"))
            with not_the_path():
                tl, tr, tst = twin.render_fallback(rigs, list_len=base.list_len,
                                                   max_pairs=max_pairs, path="pooled")
                torch.cuda.synchronize()
            if not (torch.equal(fl, tl) and torch.equal(fr, tr)) or not all(
                    torch.equal(getattr(fst, f.name), getattr(tst, f.name))
                    for f in dataclasses.fields(fst)):
                raise AssertionError("(a) the meshed pooled render differs from the meshless")
            if bool((fl.flatten(1).amax(1) <= 0).all()):
                raise AssertionError("(a) every frame is blank")
            del fl, fr, fst, tl, tr, tst
            snap_a = str(d / "snap_a")
            _p, snap_ms = timed(lambda: meshed.snapshot(snap_a))
            if CK.read_extras(snap_a, 0)["mesh"] != [["clients", 1], ["slabs", 1]]:
                raise AssertionError("(a) the snapshot does not record the 1x1 mesh")
            with not_the_path():
                back = REC.restore_service(tree, snap_a, mesh=None)
                back.codec = twin.codec
                same_service(torch, back, twin, "(a) the meshed snapshot restored meshless",
                             delta=False)
                cams = {c: walks[c][t_walk[0] * w] for c in twin.active_ids}
                same_service(torch, back, twin, "(a) one sync after the restore",
                             back.sync(cams), twin.sync(cams))
            del back
            warm_m = [r["meshed_ms"] for r in rows if r["what"] == "capacity 16"][-1]
            warm_t = [r["meshless_ms"] for r in rows if r["what"] == "capacity 16"][-1]
            report["in_process"] = dict(rows=rows, render_ms=render_ms, snapshot_ms=snap_ms,
                                        nack=dict(client=victim, page=page, rows=lost),
                                        partial_ticks=partial, warm_sync_ms=dict(
                                            meshed=warm_m, meshless=warm_t))
            del meshed, twin, scheds
            gc.collect()
            torch.cuda.empty_cache()
            # the vmapped scheduler (K1 on each rank) on the mesh and off it
            vm = mesh_service(SV, tree, cfg, focal, mesh, RAGGED_START, mode="vmapped")
            with not_the_path():
                vt = mesh_service(SV, tree, cfg, focal, None, RAGGED_START, mode="vmapped")
            vt.codec = vm.codec
            vmapped_ms = []
            for k in range(MESH_VMAPPED_SYNCS):
                cams = {c: walks[c][k * w] for c in vm.active_ids}
                sm, ms_v = timed(lambda: vm.sync(cams))
                with not_the_path():
                    st = vt.sync(cams)
                same_service(torch, vm, vt, f"(a) vmapped sync {k}", sm, st)
                vmapped_ms.append(ms_v)
            del vm, vt, sm, st
            report["in_process"]["vmapped_sync_ms"] = vmapped_ms
            log(f"[mesh] (a) 1x1 NCCL mesh on {card}: {len([r for r in rows if 'capacity' in r])} "
                f"syncs and {MESH_TICKS} ticks ({partial} partial) equal to the meshless "
                f"service bit for bit, a NACK of page {page} ({lost} rows), a shrink to 8 "
                f"slots, resize_mesh(None) and back, the pooled render ({render_ms:.1f} ms) "
                f"and the snapshot restored meshless, each sync's payload equal too; "
                f"{MESH_VMAPPED_SYNCS} vmapped syncs equal ({[round(x, 2) for x in vmapped_ms]} "
                f"ms meshed); warm sync at capacity 16: meshed {warm_m:.2f} ms, meshless "
                f"{warm_t:.2f} ms")
        finally:
            destroy_fleet_group()

        # (b) four gloo ranks sharing the card on a 2x2 mesh -------------------
        # the meshless reference first, its render's memory returned to the
        # card before the ranks start
        with not_the_path():
            rows_b, ms_b, deltas_b, last_b = mesh_script(torch, twin_b, walks, w)
            rigs = mesh_rigs(C, twin_b, extent, focal, width, height, dev)
            max_pairs = max_pairs_of(twin_b, rigs)
            tl, tr, _tst = twin_b.render_fallback(rigs, list_len=base.list_len,
                                                  max_pairs=max_pairs, path="pooled")
            twin_digests = frame_digests(torch, tl, tr, 0)
            del tl, tr, _tst, rigs
            twin_totals = SH.fleet_totals(last_b)
        gc.collect()
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info()
        log(f"[mesh] (b) the card before the ranks' script: {free / 2**30:.1f} of "
            f"{total / 2**30:.1f} GiB free; this process holds "
            f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")
        (d / "go.json.tmp").write_text(json.dumps({"max_pairs": max_pairs}))
        os.rename(d / "go.json.tmp", d / "go.json")
        t_ranks = time.perf_counter()
        for r, pr in enumerate(procs):
            try:
                rc = pr.wait(timeout=MESH_WAIT_S)
            except subprocess.TimeoutExpired:
                raise AssertionError(f"rank {r} outlived {MESH_WAIT_S} s") from None
            if rc != 0:
                tail = (d / f"rank_{r}.log").read_text()[-3000:]
                raise AssertionError(f"rank {r} exited {rc}:\n{tail}")
        ranks_ms = (time.perf_counter() - t_ranks) * 1e3
        ranks = [json.loads((d / f"rank_{r}.json").read_text()) for r in range(n_ranks)]
        got = torch.load(d / "results.pt", weights_only=False)
        for k, (a, b) in enumerate(zip(got["rows"], rows_b, strict=True)):
            for f in dataclasses.fields(b):
                x, y = getattr(a, f.name), getattr(b, f.name)
                if x.dtype != y.dtype or not torch.equal(x, y):
                    raise AssertionError(f"(b) sync {k}: the 2x2 mesh's {f.name} differs "
                                         f"from the meshless service's")
        for k, (a, b) in enumerate(zip(got["deltas"], deltas_b, strict=True)):
            if a != b:
                bad = sorted(c for c in set(a) | set(b) if a.get(c) != b.get(c))
                raise AssertionError(f"(b) sync {k}: the 2x2 mesh's decoded Δ slices of "
                                     f"clients {bad} differ from the meshless service's")
        for f in dataclasses.fields(twin_totals):
            x, y = getattr(got["totals"], f.name), getattr(twin_totals, f.name).cpu()
            ok = (torch.allclose(x, y, rtol=1e-6, atol=0.0) if y.is_floating_point()
                  else torch.equal(x, y))
            if x.dtype != y.dtype or not ok:
                raise AssertionError(f"(b) fleet_totals {f.name}: {x} vs {y}")
        for rk in ranks:
            for slot, digest in rk["digests"].items():
                if twin_digests[slot] != digest:
                    raise AssertionError(f"(b) rank {rk['rank']}: slot {slot}'s frames "
                                         f"differ from the meshless render")
            require_launched(f"mesh rank {rk['rank']}", rk["counts"],
                             ("lod_pair_sweep", "vq_assign", "rasterize_slabs",
                              "preprocess", "stereo_merge", "bin_tiles"))
            if sorted(rk["checked"]) != ["K5", "K6"]:
                raise AssertionError(f"(b) rank {rk['rank']} checked {rk['checked']}")
        with not_the_path():
            back = REC.restore_service(tree, str(d / "snap"), mesh=None)
            back.codec = twin_b.codec
            same_service(torch, back, twin_b, "(b) the 2x2 snapshot restored meshless",
                         delta=False)
        if CK.read_extras(str(d / "snap"), 0)["mesh"] != [["clients", 2], ["slabs", 2]]:
            raise AssertionError("(b) the snapshot does not record the 2x2 mesh")
        del back, twin_b
        whole = None
        for rk in ranks:
            log(f"[mesh] (b) rank {rk['rank']} {tuple(rk['coords'])} on {card}: syncs "
                f"{[round(x, 2) for x in rk['sync_ms']]} ms, of which collectives "
                f"{[round(x, 2) for x in rk['collective_ms']]} ms "
                f"({rk['collective_calls']} calls); snapshot {rk['snapshot_ms']:.1f} ms; "
                f"pooled render {rk['render_ms']:.1f} ms; resident (tree, state, tables) "
                f"{rk['resident_bytes']} bytes, allocated {rk['allocated_bytes']} bytes; "
                f"K6 and K5 == plain at this rank's largest launches {rk['checked']}; "
                f"launches {json.dumps(rk['counts'])}")
        with not_the_path():
            ref = mesh_service(SV, tree, cfg, focal, None, MESH_CAPACITY)
            whole = SH.shard_resident_bytes(None, ref.tree, ref.state, ref.tables)
            del ref
        log(f"[mesh] (b) 2x2 gloo mesh, {n_ranks} ranks time-sharing {card}: "
            f"{MESH_SYNCS} syncs (an admit, an evict) and the pooled render equal to the "
            f"meshless service bit for bit (stats, every live client's decoded Δ slice "
            f"after every sync and frames by sha256 per slot, the snapshot restored "
            f"meshless), fleet_totals within rtol 1e-6; meshless syncs "
            f"{[round(x, 2) for x in ms_b]} ms; each rank's resident bytes (tree, state, "
            f"tables) {[rk['resident_bytes'] for rk in ranks]} against {whole} meshless; "
            f"the ranks finished {ranks_ms:.0f} ms after the parent's own work")
        report["ranks"] = ranks
        report["meshless_b"] = dict(sync_ms=ms_b, resident_bytes=whole)
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
        shutil.rmtree(d, ignore_errors=True)
    counts = {name: n - aside[name] for name, n in K.launch_counts().items()}
    for rk in report["ranks"]:
        for name, n in rk["counts"].items():
            counts[name] += n
    require_launched("mesh", counts, ("lod_slab_sweep", "lod_pair_sweep", "vq_assign",
                                      "rasterize_slabs", "preprocess", "stereo_merge",
                                      "bin_tiles"))
    report["aside"] = aside
    report["counts"] = counts
    return report


def lm_serving(torch, dev) -> dict:
    """Phase 9: the dense LM serving path at full width and depth, then its
    float32 checks. Returns the phase's report, with the launch counts of
    the main path under "counts"."""
    from repro_torch import kernels as K
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import attention as MA
    from repro_torch.models import model_zoo

    def plain_k7(q, k, v, *, causal, window):
        return FA.flash_attention_plain(q, k, v, causal=causal, window=window)

    def serving_plain(q, k, v, *, causal, window):
        # the JAX serving `attention`'s rounding: q and p kept in float32
        t = (lambda x: x.transpose(1, 2))
        return t(MA.attention_plain(t(q), t(k), t(v), causal=causal, window=window))

    def substituted(fn=plain_k7):
        # `fn` in K7's place in the model: no switch in the package
        return mock.patch.object(MA, "flash_attention", fn)

    cfg = get_arch(LM_ARCH)
    bundle = model_zoo.get_model(cfg)
    b, s0, steps = LM_BATCH, LM_PROMPT, LM_STEPS
    max_len = s0 + steps
    t0 = time.perf_counter()
    model = bundle.init(seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[lm] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads}/"
        f"{cfg.n_kv_heads} heads of {cfg.hd}, vocab {cfg.vocab} (padded "
        f"{cfg.vocab_padded}), {cfg.dtype}; {n_params} parameters from seed 0 in "
        f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (b, s0), generator=gen, device=dev)
    warm = torch.randint(0, cfg.vocab, (b, 128), generator=gen, device=dev)
    bundle.decode_step(model, bundle.prefill(model, {"tokens": warm}, max_len=130)[1],
                       {"token": warm[:, 0]})          # first-call set-up, not timed

    def greedy(logits):
        return logits[:, :cfg.vocab].argmax(-1)

    # the main path: counters at 0, one prefill, `steps` greedy decode steps
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = bundle.prefill(model, {"tokens": tokens}, max_len=max_len)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    k7_prefill = K.launch_counts()["flash_attention"]
    prefill_logits = logits
    toks = [greedy(logits)]
    step_ms = []
    for _ in range(steps):
        t1 = time.perf_counter()
        logits, cache = bundle.decode_step(model, cache, {"token": toks[-1]})
        toks.append(greedy(logits))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    toks = torch.stack(toks, 1)                          # (B, steps + 1)
    log(f"[lm] kernels {json.dumps(counts)}")
    if k7_prefill != cfg.n_layers or counts["flash_attention"] != cfg.n_layers:
        raise AssertionError(f"K7 launched {k7_prefill} times in the prefill and "
                             f"{counts['flash_attention']} in all, not {cfg.n_layers} "
                             f"(once a layer, in the prefill only)")
    if tuple(logits.shape) != (b, cfg.vocab_padded) or not torch.isfinite(logits).all():
        raise AssertionError(f"decode logits: shape {tuple(logits.shape)} or non-finite")
    if cache["pos"] != max_len or tuple(cache["layers"][0]["k"].shape) != (
            b, max_len, cfg.n_kv_heads, cfg.hd):
        raise AssertionError(f"cache: pos {cache['pos']}, k {tuple(cache['layers'][0]['k'].shape)}")
    step_med = statistics.median(step_ms)
    out = dict(arch=cfg.name, layers=cfg.n_layers, dtype=cfg.dtype, params=n_params,
               batch=b, prompt=s0, steps=steps, max_len=max_len, prefill_ms=prefill_ms,
               prefill_tokens_per_s=b * s0 / prefill_ms * 1e3, decode_step_ms=step_ms,
               decode_step_ms_median=step_med, decode_tokens_per_s=b / step_med * 1e3,
               peak_bytes=peak, counts=counts)
    log(f"[lm] prefill {b}x{s0}: {prefill_ms:.2f} ms ({out['prefill_tokens_per_s']:.0f} "
        f"tokens/s); decode step median {step_med:.2f} ms (min {min(step_ms):.2f}, max "
        f"{max(step_ms):.2f}; {out['decode_tokens_per_s']:.1f} tokens/s at batch {b}); "
        f"peak memory {peak / 2**30:.2f} GiB")

    prof = profiled(torch, f"one more prefill {b}x{s0}",
                    lambda: bundle.prefill(model, {"tokens": tokens}, max_len=max_len))
    k7_ms = sum(t for name, t in prof["by_name"].items()
                if "flash_attention_wgmma" in name or "flash_attention_kernel" in name)
    out["profile"] = dict(wall_ms=prof["wall_ms"], device_busy_ms=prof["device_busy_ms"],
                          k7_ms=k7_ms, top=prof["top"])
    if prof["device_busy_ms"] > 0:
        out["k7_share"] = k7_ms / prof["device_busy_ms"]
        log(f"[lm] K7 takes {k7_ms:.2f} ms of the prefill's {prof['device_busy_ms']:.2f} ms "
            f"device time: share {out['k7_share']:.3f}")
    else:
        out["k7_share"] = None
    # the cache is full (pos = max_len): this step writes the clamped last slot,
    # with the same shapes as the last timed step
    dprof = profiled(torch, f"one more decode step at batch {b}",
                     lambda: bundle.decode_step(model, cache, {"token": toks[:, -1]}))
    out["decode_profile"] = dict(wall_ms=dprof["wall_ms"],
                                 device_busy_ms=dprof["device_busy_ms"], top=dprof["top"])

    # bf16, full depth: the prefill logits and the greedy tokens with another
    # function in K7's place, fed the same tokens (teacher-forced), so that
    # one flip does not cascade
    for key, fn, what in (("plain_k7", plain_k7, "K7's plain version"),
                          ("serving_plain", serving_plain, "attention_plain (JAX serving "
                                                           "rounding)")):
        with substituted(fn):
            lp, cp = bundle.prefill(model, {"tokens": tokens}, max_len=max_len)
            gap = rel_err(prefill_logits.float(), lp.float())
            ptoks = [greedy(lp)]
            for t in range(steps):
                lp, cp = bundle.decode_step(model, cp, {"token": toks[:, t]})
                ptoks.append(greedy(lp))
        agree = float((torch.stack(ptoks, 1) == toks).float().mean())
        out[f"bf16_vs_{key}"] = dict(prefill_logits_rel_gap=gap, greedy_agreement=agree)
        log(f"[lm] bf16, K7 vs {what} substituted: prefill logits max |diff| / max |logit| "
            f"= {gap:.4g}; greedy tokens (teacher-forced, {b} x {steps + 1}) agree "
            f"{agree:.4f}")
        del lp, cp
    del model, cache, logits, prefill_logits
    gc.collect()
    torch.cuda.empty_cache()

    # float32 checks at full width, LM_CHECK_LAYERS layers
    cfg32 = dataclasses.replace(cfg, n_layers=LM_CHECK_LAYERS, dtype="float32")
    b32 = model_zoo.get_model(cfg32)
    m32 = b32.init(seed=0, device=dev)
    la, ca = b32.prefill(m32, {"tokens": tokens}, max_len=max_len)
    with substituted():
        lb, _ = b32.prefill(m32, {"tokens": tokens}, max_len=max_len)
    err_a = rel_err(la, lb)
    log(f"[lm check a] float32, {LM_CHECK_LAYERS} layers: prefill logits with K7 vs its "
        f"plain version: max |diff| / max |logit| = {err_a:.3g}")
    if not err_a <= LM_REL_TOL:
        raise AssertionError(f"check (a): {err_a:.3g} > {LM_REL_TOL}")
    dec_logits, dtoks = [], [greedy(la)]
    for _ in range(steps):
        la, ca = b32.decode_step(m32, ca, {"token": dtoks[-1]})
        dec_logits.append(la)
        dtoks.append(greedy(la))
    err_b = {}
    for t in sorted({1, max(1, steps // 2), steps}):
        full = torch.cat([tokens, torch.stack(dtoks[:t], 1)], 1)
        lf, _ = b32.prefill(m32, {"tokens": full})
        err_b[t] = rel_err(dec_logits[t - 1], lf)
        log(f"[lm check b] decode step {t} logits vs a prefill over the prompt + {t} "
            f"decoded tokens ({full.shape[1]} positions): {err_b[t]:.3g}")
    if not max(err_b.values()) <= LM_REL_TOL:
        raise AssertionError(f"check (b): {err_b} > {LM_REL_TOL}")
    out["check_a_rel_err"] = err_a
    out["check_b_rel_err"] = err_b
    del m32, ca
    gc.collect()
    torch.cuda.empty_cache()
    return out


def k7_case_list() -> list:
    """Phase 10's cases, (name, B, H, Hkv, L, D, dtype, causal, window), each
    shape taken from its config. The first is phase 9's prefill attention."""
    from repro_torch.configs import get_arch

    lm, wa = get_arch(LM_ARCH), get_arch(WINDOW_ARCH)
    prefill = (LM_BATCH, lm.n_heads, lm.n_kv_heads, LM_PROMPT, lm.hd)
    local = (1, wa.n_heads, wa.n_kv_heads, LM_PROMPT, wa.hd)
    # phase 14's call patterns: the two MoE prefills (GQA groups 2 and 16), an
    # enc-dec's encoder layer over the stub frames and its causal decoder
    # self-attention, Zamba2's shared block (head dim 80); phase 15 (a)'s
    # training forward (batch 1, twice phase 9's length), and phase 15 (d)'s:
    # gemma3-4b's local and global layers
    gm, qm, enc, zb = (get_arch(n) for n in ("granite-moe-1b-a400m", "qwen3-moe-235b-a22b",
                                             "seamless-m4t-medium", "zamba2-2.7b"))
    tr = get_arch(TRAIN_ARCH)
    frames = LM_PROMPT // enc.audio_downsample
    return [(f"{lm.name} prefill", *prefill, lm.dtype, True, lm.sliding_window),
            (f"{lm.name} prefill f32", *prefill, "float32", True, lm.sliding_window),
            (f"{wa.name} local layer", *local, wa.dtype, True, wa.sliding_window),
            (f"{wa.name} local layer f32", *local, "float32", True, wa.sliding_window),
            (f"{lm.name} non-causal", *prefill, lm.dtype, False, 0),
            (f"{gm.name} prefill", LM_BATCH, gm.n_heads, gm.n_kv_heads, LM_PROMPT, gm.hd,
             gm.dtype, True, 0),
            (f"{qm.name} prefill", LM_BATCH, qm.n_heads, qm.n_kv_heads, LM_PROMPT, qm.hd,
             qm.dtype, True, 0),
            (f"{enc.name} encoder", LM_BATCH, enc.n_heads, enc.n_kv_heads, frames, enc.hd,
             enc.dtype, False, 0),
            (f"{enc.name} decoder", LM_BATCH, enc.n_heads, enc.n_kv_heads, LM_PROMPT, enc.hd,
             enc.dtype, True, 0),
            (f"{zb.name} shared block", LM_BATCH, zb.n_heads, zb.n_kv_heads, LM_PROMPT, zb.hd,
             zb.dtype, True, 0),
            (f"{tr.name} train", TRAIN_BATCH, tr.n_heads, tr.n_kv_heads, TRAIN_SEQ, tr.hd,
             tr.dtype, True, tr.sliding_window),
            (f"{tr.name} train f32", TRAIN_BATCH, tr.n_heads, tr.n_kv_heads, TRAIN_SEQ, tr.hd,
             "float32", True, tr.sliding_window),
            *((f"{wa.name} train {kind}", TRAIN_BATCH, wa.n_heads, wa.n_kv_heads, TRAIN_SEQ,
               wa.hd, wa.dtype, True, window) for kind, window in gemma3_train_layers(wa))]


def gemma3_train_layers(wa) -> tuple:
    """The attention layers of phase 15 (d)'s step, (kind, window): the
    local layer's window and the global layer's none."""
    return (("local", wa.sliding_window), ("global", 0))


def k7_bound(dtype_name: str, t_bytes: float, ops: float) -> dict:
    """K7's bound at its route's rate: bf16 on wgmma at the bf16 peak;
    float32 as three TF32 products (`tf32x3`) at a third of the TF32 peak,
    with the bound at the float32 units' rate beside it (`bound_ms_fma`)."""
    if dtype_name == "bfloat16":
        t_ops, extra = ops / BF16_OPS_PER_S * 1e3, {}
    else:
        t_ops = ops / TF32X3_OPS_PER_S * 1e3
        extra = dict(bound_ms_fma=max(t_bytes, ops / FP32_OPS_PER_S * 1e3))
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else
                "operations", **extra)


def attention_f64(torch, q, k, v, causal: bool, window: int):
    """Softmax attention evaluated in float64 from q, k, v (B, H, L, D) cast
    up, with K7's masks: the reference phase 10 holds both float32 versions
    of K7 (the kernel and the plain version) to, forward and gradient."""
    q, k, v = (t.double() for t in (q, k, v))
    g = q.shape[1] // k.shape[1]
    k, v = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    r = torch.arange(q.shape[2], device=q.device)[:, None]
    c = torch.arange(k.shape[2], device=q.device)[None, :]
    vis = (c <= r) if causal else torch.ones_like(c <= r)
    if window > 0:
        vis = vis & (c > r - window)
    s = ((q / q.shape[-1] ** 0.5) @ k.transpose(-1, -2)).masked_fill(~vis, -torch.inf)
    return torch.softmax(s, -1) @ v


def k7_cases(torch, dev) -> list:
    """Phase 10: K7 against its plain version at the LM shapes, each timed
    by events beside its bound (float32 at both rates, `k7_bound`) and
    `scaled_dot_product_attention` (a yardstick only), with its route; the
    device time comes later, from a fresh process (`fill_k7_device_ms`)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA

    rows = []
    for name, b, h, hkv, length, d, dtype_name, causal, window in k7_case_list():
        dtype = getattr(torch, dtype_name)
        gen = torch.Generator(device=dev).manual_seed(length + d)
        # (B, L, H, D) tensors as transposed views, as models.attention passes them
        q, k, v = (torch.randn((b, length, n, d), generator=gen, device=dev)
                   .to(dtype).transpose(1, 2) for n in (h, hkv, hkv))
        kw = dict(causal=causal, window=window)
        out = FA.flash_attention(q, k, v, **kw)
        ref = FA.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
        err = float((out.float() - ref.float()).abs().max())
        if not torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol):
            raise AssertionError(f"K7 {name}: differs from its plain version "
                                 f"(max |err| {err:.3g}, tolerance {tol})")
        rows_ = torch.arange(length)
        hi = rows_ if causal else torch.full_like(rows_, length - 1)
        lo = (rows_ - window + 1).clamp_min(0) if window > 0 else torch.zeros_like(rows_)
        pairs = int((hi - lo + 1).clamp_min(0).sum())
        es = q.element_size()
        n_bytes = 2 * b * h * length * d * es + 2 * b * hkv * length * d * es
        ops = 4 * d * b * h * pairs
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        if window > 0:   # the library call takes the window as an explicit mask
            r, c = rows_[:, None].to(dev), rows_[None, :].to(dev)
            lib_kw = dict(attn_mask=(c <= r) & (c > r - window))
        else:
            lib_kw = dict(is_causal=causal)
        rt = FA.fwd_route(d, dtype)
        row = dict(case=name, shape=[b, h, hkv, length, d], dtype=dtype_name, route=rt.route,
                   causal=causal, window=window, max_abs_err=err, tolerance=tol,
                   ms=cuda_ms(torch, lambda: FA.flash_attention(q, k, v, **kw), REPS),
                   plain_ms=cuda_ms(torch, lambda: FA.flash_attention_plain(q, k, v, **kw), 3),
                   library_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                       q, k, v, enable_gqa=True, **lib_kw), REPS),
                   visible_pairs=pairs, bytes=n_bytes, ops=ops,
                   **k7_bound(dtype_name, t_bytes, ops))
        row["bound_share"] = row["bound_ms"] / row["ms"]
        row["vs_library"] = row["ms"] / row["library_ms"]
        f64 = ""
        if dtype == torch.float32:   # how close each float32 version comes to float64
            ref64 = attention_f64(torch, q, k, v, causal, window)
            row["rel_err_vs_float64"] = rel_err(out.double(), ref64)
            row["plain_rel_err_vs_float64"] = rel_err(ref.double(), ref64)
            f64 = (f"; of scale vs float64: kernel {row['rel_err_vs_float64']:.3g}, plain "
                   f"{row['plain_rel_err_vs_float64']:.3g}")
            del ref64
        d_pad = rt.d_pad if rt.route == "wgmma" else d
        if d_pad != d:   # what the padding costs: the same call at the padded head dim
            qp, kp, vp = (torch.randn((b, length, n, d_pad), generator=gen, device=dev)
                          .to(dtype).transpose(1, 2) for n in (h, hkv, hkv))
            row["padded_head_dim"] = d_pad
            row["ms_at_padded_head_dim"] = cuda_ms(
                torch, lambda: FA.flash_attention(qp, kp, vp, **kw), REPS)
            row["bound_ms_at_padded_head_dim"] = row["bound_ms"] * d_pad / d
            log(f"[K7] {name} at head dim {d_pad}: {row['ms_at_padded_head_dim']:.4f} ms "
                f"against {row['ms']:.4f} ms at {d}")
            del qp, kp, vp
        fma = (f", at the FMA rate {row['bound_ms_fma']:.4f} ms" if "bound_ms_fma" in row
               else "")
        log(f"[K7] {name} {row['shape']} {row['dtype']} route {row['route']} causal={causal} "
            f"window={window}: {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.3f} ms, sdpa {row['library_ms']:.4f} ms (K7 / sdpa "
            f"{row['vs_library']:.3f}), bound {row['bound_ms']:.4f} ms ({row['bound_by']}; "
            f"share {row['bound_share']:.4f}){fma}, max |err| {err:.3g}{f64}")
        rows.append(row)
        del q, k, v, out, ref
    torch.cuda.empty_cache()
    return rows


K7_BWD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}   # phase 10's backward, of each grad's scale


def k7_backward_case_list() -> list:
    """Phase 10's backward cases, (name, B, H, Hkv, L, D, causal, window),
    each in bf16 and float32: phase 15 (a)'s training shape, the family
    patterns phase 15 (c) trains through K7 (granite-moe's GQA group 2 at
    head dim 64, seamless's non-causal encoder over the stub frames,
    zamba2's shared block at head dim 80) at phase 10's forward shapes,
    gemma3-4b's local layer (window 1024, head dim 320), the widest input K7
    takes, paligemma-3b's heads (8/1 of 256, causal: bucket 256), and
    phase 15 (d)'s two: gemma3-4b's local and global layers at its training
    shape (1 x 8/4 of 320 over TRAIN_SEQ)."""
    from repro_torch.configs import get_arch

    tr, gm, enc, zb, wa, pg = (get_arch(n) for n in (TRAIN_ARCH, "granite-moe-1b-a400m",
                                                     "seamless-m4t-medium", "zamba2-2.7b",
                                                     WINDOW_ARCH, "paligemma-3b"))
    return [(f"{tr.name} train", TRAIN_BATCH, tr.n_heads, tr.n_kv_heads, TRAIN_SEQ, tr.hd, True,
             tr.sliding_window),
            (f"{gm.name} prefill", LM_BATCH, gm.n_heads, gm.n_kv_heads, LM_PROMPT, gm.hd, True,
             0),
            (f"{enc.name} encoder", LM_BATCH, enc.n_heads, enc.n_kv_heads,
             LM_PROMPT // enc.audio_downsample, enc.hd, False, 0),
            (f"{zb.name} shared block", LM_BATCH, zb.n_heads, zb.n_kv_heads, LM_PROMPT, zb.hd,
             True, 0),
            (f"{wa.name} local layer", 1, wa.n_heads, wa.n_kv_heads, LM_PROMPT, wa.hd, True,
             wa.sliding_window),
            (f"{pg.name} head dim {pg.hd}", 1, pg.n_heads, pg.n_kv_heads, LM_PROMPT, pg.hd, True,
             0),
            *((f"{wa.name} train {kind}", TRAIN_BATCH, wa.n_heads, wa.n_kv_heads, TRAIN_SEQ,
               wa.hd, True, window) for kind, window in gemma3_train_layers(wa))]


def k7_backward_cases(torch, dev) -> list:
    """Phase 10, the backward: at each shape of `k7_backward_case_list`, in
    bf16 and float32, K7's forward (with lse) and the backward kernel on
    seeded (B, L, H, D) views and output gradient, held against
    `flash_attention_backward_plain` on the same (out, lse) and against the
    autograd gradient of `flash_attention_plain`, each gradient within
    `K7_BWD_TOL` of its largest |value|, and two runs equal bit for bit;
    timed by events beside its bound, the plain version, the route it
    replaced (autograd through the plain version, forward included) and the
    backward of `scaled_dot_product_attention` (a yardstick only). The
    device time comes later, from a fresh process (`fill_k7_device_ms`)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA

    rows = []
    for name, b, h, hkv, length, d, causal, window in k7_backward_case_list():
        for dtype_name in ("bfloat16", "float32"):
            dtype = getattr(torch, dtype_name)
            gen = torch.Generator(device=dev).manual_seed(7 * length + d)
            q, k, v, dout = (torch.randn((b, length, n, d), generator=gen, device=dev)
                             .to(dtype).transpose(1, 2) for n in (h, hkv, hkv, h))
            kw = dict(causal=causal, window=window)
            lse = torch.empty((b, h, length), dtype=torch.float32, device=dev)
            out = FA._launch(q, k, v, causal, window, lse)
            got = FA.flash_attention_backward(q, k, v, out, lse, dout, **kw)
            again = FA.flash_attention_backward(q, k, v, out, lse, dout, **kw)
            plain = FA.flash_attention_backward_plain(q, k, v, out, lse, dout, **kw)
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            auto = torch.autograd.grad(FA.flash_attention_plain(*leaves, **kw), leaves, dout)
            torch.cuda.synchronize()
            tol = K7_BWD_TOL[dtype_name]
            err_plain = max(rel_err(a.float(), r.float()) for a, r in zip(got, plain))
            err_auto = max(rel_err(a.float(), r.float()) for a, r in zip(got, auto))
            abs_err = max(float((a.float() - r.float()).abs().max()) for a, r in zip(got, plain))
            if not (err_plain <= tol and err_auto <= tol):
                raise AssertionError(f"K7 backward {name} {dtype_name}: {err_plain:.3g} of scale "
                                     f"from its plain version, {err_auto:.3g} from the plain "
                                     f"autograd gradient (tolerance {tol})")
            if not all(torch.equal(a, c) for a, c in zip(got, again)):   # no atomics
                raise AssertionError(f"K7 backward {name} {dtype_name}: two runs differ")
            del again
            f64 = {}
            if dtype == torch.float32:   # how close each float32 version comes to float64
                leaves64 = [t.detach().double().requires_grad_() for t in (q, k, v)]
                g64 = torch.autograd.grad(attention_f64(torch, *leaves64, causal, window),
                                          leaves64, dout.double())
                f64 = dict(rel_err_vs_float64=max(rel_err(a.double(), r)
                                                  for a, r in zip(got, g64)),
                           plain_rel_err_vs_float64=max(rel_err(a.double(), r)
                                                        for a, r in zip(plain, g64)))
                del leaves64, g64
            del plain, auto
            rows_ = torch.arange(length)
            hi = rows_ if causal else torch.full_like(rows_, length - 1)
            lo = (rows_ - window + 1).clamp_min(0) if window > 0 else torch.zeros_like(rows_)
            pairs = int((hi - lo + 1).clamp_min(0).sum())
            es = q.element_size()
            # q, k, v, out, dout and lse read once; dq, dk, dv written once
            n_bytes = (4 * b * h * length * d + 4 * b * hkv * length * d) * es + b * h * length * 4
            ops = 10 * d * b * h * pairs               # five products of 2 D a visible pair
            t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3

            def kernel():
                return FA.flash_attention_backward(q, k, v, out, lse, dout, **kw)

            def old_route():             # what FlashAttentionFn.backward ran before the kernel
                return torch.autograd.grad(FA.flash_attention_plain(*leaves, **kw), leaves, dout)

            row = dict(case=name, shape=[b, h, hkv, length, d], dtype=dtype_name, causal=causal,
                       window=window, deterministic=True, max_abs_err=abs_err,
                       rel_err_vs_plain=err_plain,
                       rel_err_vs_autograd=err_auto, tolerance=tol, **f64,
                       ms=cuda_ms(torch, kernel, REPS),
                       plain_ms=cuda_ms(torch, lambda: FA.flash_attention_backward_plain(
                           q, k, v, out, lse, dout, **kw), 3),
                       plain_autograd_ms=cuda_ms(torch, old_route, 3),
                       visible_pairs=pairs, bytes=n_bytes, ops=ops,
                       **k7_bound(dtype_name, t_bytes, ops))
            if window > 0:   # the library call takes the window as an explicit mask
                r, c = rows_[:, None].to(dev), rows_[None, :].to(dev)
                lib_kw = dict(attn_mask=(c <= r) & (c > r - window))
            else:
                lib_kw = dict(is_causal=causal)
            try:                         # a yardstick: the port never calls it
                lo_ = F.scaled_dot_product_attention(*leaves, enable_gqa=True, **lib_kw)
                row["library_ms"] = cuda_ms(torch, lambda: torch.autograd.grad(
                    lo_, leaves, dout, retain_graph=True), REPS)
                del lo_
            except RuntimeError as e:
                log(f"[K7 bwd] {name} {dtype_name}: sdpa's backward failed ({e}): not measured")
                row["library_ms"] = None
            row["bound_share"] = row["bound_ms"] / row["ms"]
            rt = FA.bwd_route(d, dtype)
            row.update(route=rt.route, padded_head_dim=rt.d_pad, dq_blocks=list(rt.dq_blocks),
                       dkv_blocks=list(rt.dkv_blocks))
            if row["library_ms"]:
                row["vs_library"] = row["ms"] / row["library_ms"]
            if rt.route == "wgmma" and rt.d_pad != d:
                # what the padding costs: the same call at the padded head dim
                qp, kp, vp, dop = (torch.randn((b, length, n, rt.d_pad), generator=gen,
                                               device=dev).to(dtype).transpose(1, 2)
                                   for n in (h, hkv, hkv, h))
                lsep = torch.empty((b, h, length), dtype=torch.float32, device=dev)
                outp = FA._launch(qp, kp, vp, causal, window, lsep)
                row["ms_at_padded_head_dim"] = cuda_ms(torch, lambda: FA.flash_attention_backward(
                    qp, kp, vp, outp, lsep, dop, **kw), REPS)
                row["bound_ms_at_padded_head_dim"] = row["bound_ms"] * rt.d_pad / d
                log(f"[K7 bwd] {name} at head dim {rt.d_pad}: "
                    f"{row['ms_at_padded_head_dim']:.4f} ms against {row['ms']:.4f} ms at {d} "
                    f"(ratio {row['ms'] / row['ms_at_padded_head_dim']:.3f})")
                del qp, kp, vp, dop, lsep, outp
            log(f"[K7 bwd] {name} {dtype_name}: route {rt.route}, head dim {d} in bucket "
                f"{rt.d_pad}, dQ pass blocks {rt.dq_blocks}, dK/dV pass blocks {rt.dkv_blocks}")
            log(f"[K7 bwd] {name} {row['shape']} {dtype_name} causal={causal} window={window}: "
                f"{row['ms']:.4f} ms, plain "
                f"{row['plain_ms']:.3f} ms, plain autograd {row['plain_autograd_ms']:.3f} ms, "
                f"sdpa backward {fmt_ms(row['library_ms'])} (kernel / sdpa "
                f"{row['vs_library'] if row.get('vs_library') else float('nan'):.3f}), bound "
                f"{row['bound_ms']:.4f} ms "
                f"({row['bound_by']}; share {row['bound_share']:.4f})"
                + (f", at the FMA rate {row['bound_ms_fma']:.4f} ms" if "bound_ms_fma" in row
                   else "") + f"; of scale "
                f"{err_plain:.3g} vs plain, {err_auto:.3g} vs autograd, max |err| {abs_err:.3g}"
                + (f"; vs float64: kernel {f64['rel_err_vs_float64']:.3g}, plain "
                   f"{f64['plain_rel_err_vs_float64']:.3g}" if f64 else ""))
            rows.append(row)
            del q, k, v, dout, out, lse, got, leaves
            torch.cuda.empty_cache()
    return rows


def k7_device_times(torch, dev) -> dict:
    """`--k7-device-ms`: phase 10's K7 device times, forward and backward at
    each of its shapes, on the same seeded inputs, by `device_ms` in this
    process, which has run nothing else. (In a whole run the profiler
    recorded none of phase 10's forward launches and 33 of 40 backward
    ones; a fresh process records them all.) Keys "fwd|case|dtype" and
    "bwd|case|dtype"."""
    from repro_torch.kernels import flash_attention as FA

    out = {}
    for name, b, h, hkv, length, d, dtype_name, causal, window in k7_case_list():
        gen = torch.Generator(device=dev).manual_seed(length + d)
        q, k, v = (torch.randn((b, length, n, d), generator=gen, device=dev)
                   .to(getattr(torch, dtype_name)).transpose(1, 2) for n in (h, hkv, hkv))
        out[f"fwd|{name}|{dtype_name}"] = device_ms(
            torch, lambda: FA.flash_attention(q, k, v, causal=causal, window=window),
            "flash_attention")
        del q, k, v
    for name, b, h, hkv, length, d, causal, window in k7_backward_case_list():
        for dtype_name in ("bfloat16", "float32"):
            gen = torch.Generator(device=dev).manual_seed(7 * length + d)
            q, k, v, dout = (torch.randn((b, length, n, d), generator=gen, device=dev)
                             .to(getattr(torch, dtype_name)).transpose(1, 2)
                             for n in (h, hkv, hkv, h))
            lse = torch.empty((b, h, length), dtype=torch.float32, device=dev)
            o = FA._launch(q, k, v, causal, window, lse)
            out[f"bwd|{name}|{dtype_name}"] = device_ms(
                torch, lambda: FA.flash_attention_backward(q, k, v, o, lse, dout, causal=causal,
                                                           window=window),
                "attention_bwd", per_call=3 + (h > hkv))
            del q, k, v, dout, lse, o
    torch.cuda.empty_cache()
    return out


def fill_k7_device_ms(k7: list, k7b: list) -> None:
    """Phase 10's device ms, from `chip_smoke.py --k7-device-ms` in a
    process of its own (`k7_device_times`), into each row; fails if a row
    gets none."""
    import shutil
    import tempfile
    path = Path(tempfile.mkdtemp(prefix="nebula_k7dev_")) / "k7_device_ms.json"
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--k7-device-ms",
                          str(path)], capture_output=True, text=True, timeout=600)
    if run.returncode != 0:
        raise RuntimeError(f"--k7-device-ms: exit {run.returncode}: {run.stderr[-3000:]}")
    times = json.loads(path.read_text())
    shutil.rmtree(path.parent, ignore_errors=True)
    for kind, rows in (("fwd", k7), ("bwd", k7b)):
        for row in rows:
            row["device_ms"] = times.get(f"{kind}|{row['case']}|{row['dtype']}")
            log(f"[K7{' bwd' if kind == 'bwd' else ''}] {row['case']} {row['dtype']}: device "
                f"{fmt_ms(row['device_ms'])} (a fresh process), {row['ms']:.4f} ms by events")
            if row["device_ms"] is None:
                raise AssertionError(f"phase 10: no device time for {kind} {row['case']} "
                                     f"{row['dtype']}")
    log(f"[K7] phase 10's device times in a fresh process: "
        f"{time.perf_counter() - t0:.1f} s")


def stub_inputs(torch, cfg, b: int, s: int, gen, dev) -> dict:
    """The family's stub frontend inputs for a prompt of s tokens: seeded
    image embeddings (paligemma) or audio frames (seamless)."""
    from repro_torch.models import model_zoo
    return {name: torch.randn((b,) + shape, generator=gen, device=dev)
            for name, shape in model_zoo.stub_shapes(cfg, s).items()}


def lm_families(torch, dev, card: str) -> dict:
    """Phase 14: every other LM family at full width, one config at a time,
    then its float32 checks. Returns the phase's report, with the launch
    counts of the configs' main runs, summed, under "counts"."""
    from repro_torch import kernels as K
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import attention as MA
    from repro_torch.models import model_zoo
    from repro_torch.models import moe as MOE
    from repro_torch.models import xlstm as XL

    def plain_k7(q, k, v, *, causal, window):
        return FA.flash_attention_plain(q, k, v, causal=causal, window=window)

    def recorded_routes(log_):
        """`MOE.route`, recording each call's (probs, top_e) into `log_`."""
        real = MOE.route

        def route(x, p, k):
            r = real(x, p, k)
            log_.append((r[0], r[2]))
            return r
        return mock.patch.object(MOE, "route", route)

    def forced_routes(routes, log_):
        """`MOE.route` with the experts of `routes` (a run's recorded (probs,
        top_e), one a call, in call order) and this run's own weights at
        them, renormalised as `route` renormalises them; records this run's
        own (probs, top_e) into `log_`."""
        real, it = MOE.route, iter(routes)

        def route(x, p, k):
            probs, _, own_e = real(x, p, k)
            log_.append((probs, own_e))
            top_e = next(it)[1]
            top_w = torch.gather(probs, -1, top_e)
            return probs, top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9), top_e
        return mock.patch.object(MOE, "route", route)

    def flips(probs_a, top_a, top_b) -> dict:
        """The tokens whose ordered top-k differs between run a and run b,
        and how far run a's router was from a tie on the pair that crossed:
        at the first place the two differ, run a's probability of its own
        expert less its probability of run b's, over the row's largest
        probability (`margin`) and in ulps of it (`margin_ulps`)."""
        diff = top_a != top_b
        tok = diff.any(-1)
        if not bool(tok.any()):
            return dict(tokens=0, margin=0.0, margin_ulps=0.0)
        first = diff.to(torch.int8).argmax(-1, keepdim=True)
        gap = (torch.gather(probs_a, -1, torch.gather(top_a, -1, first))
               - torch.gather(probs_a, -1, torch.gather(top_b, -1, first))).squeeze(-1)[tok]
        top = probs_a.amax(-1)[tok]
        ulp = torch.ldexp(torch.ones_like(top), torch.frexp(top).exponent - 24)
        return dict(tokens=int(tok.sum()), margin=float((gap / top).max()),
                    margin_ulps=float((gap / ulp).max()))

    b, s0, steps = LM_BATCH, LM_PROMPT, FAMILY_STEPS
    rows, path_counts = [], {name: 0 for name in K.launch_counts()}
    for name, layers in FAMILY_ARCHS:
        t_cfg = time.perf_counter()
        cfg = get_arch(name)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        bundle = model_zoo.get_model(cfg)
        model = bundle.init(seed=0, device=dev)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in model.parameters())
        gen = torch.Generator(device=dev).manual_seed(3)
        tokens = torch.randint(0, cfg.vocab, (b, s0), generator=gen, device=dev)
        batch = {"tokens": tokens, **stub_inputs(torch, cfg, b, s0, gen, dev)}
        n_img = cfg.n_img_tokens
        max_len = n_img + s0 + steps + 1           # room for the profiled step
        log(f"[families] {cfg.name} ({cfg.family}): {cfg.n_layers} layers"
            f"{f' + {cfg.n_enc_layers} encoder layers' if cfg.n_enc_layers else ''}, d "
            f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}, vocab "
            f"{cfg.vocab}, {cfg.dtype}; {n_params} parameters from seed 0")
        warm = {"tokens": tokens[:, :128], **stub_inputs(torch, cfg, b, 128, gen, dev)}
        bundle.decode_step(model, bundle.prefill(model, warm, max_len=n_img + 130)[1],
                           {"token": tokens[:, 0]})          # first-call set-up, not timed

        def greedy(logits):
            return logits[:, :cfg.vocab].argmax(-1)

        # the main path: counters at 0, one prefill, `steps` greedy decode steps
        timer = StageTimer(torch)
        slstm = (mock.patch.object(XL, "slstm_scan", timer.wrap("slstm", XL.slstm_scan))
                 if cfg.family == "xlstm" else contextlib.nullcontext())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        with slstm:
            t0 = time.perf_counter()
            logits, cache = bundle.prefill(model, batch, max_len=max_len)
            torch.cuda.synchronize()
            prefill_ms = (time.perf_counter() - t0) * 1e3
        k7_prefill = K.launch_counts()["flash_attention"]
        toks, step_ms = [greedy(logits)], []
        for _ in range(steps):
            t1 = time.perf_counter()
            logits, cache = bundle.decode_step(model, cache, {"token": toks[-1]})
            toks.append(greedy(logits))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)
        counts = K.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        for key, n in counts.items():
            path_counts[key] += n
        want = model_zoo.k7_prefill_launches(cfg)
        log(f"[families] {cfg.name} kernels {json.dumps(counts)}")
        if k7_prefill != want or counts["flash_attention"] != want:
            raise AssertionError(f"{cfg.name}: K7 launched {k7_prefill} times in the prefill "
                                 f"and {counts['flash_attention']} in all, not {want} (in the "
                                 f"prefill only)")
        if (tuple(logits.shape) != (b, cfg.vocab_padded) or not torch.isfinite(logits).all()
                or cache["pos"] != n_img + s0 + steps):
            raise AssertionError(f"{cfg.name}: decode logits {tuple(logits.shape)}, finite "
                                 f"{bool(torch.isfinite(logits).all())}, pos {cache['pos']}")
        step_med = statistics.median(step_ms)
        row = dict(arch=cfg.name, family=cfg.family, layers=cfg.n_layers,
                   enc_layers=cfg.n_enc_layers, dtype=cfg.dtype, params=n_params, batch=b,
                   prompt=s0, prefix=n_img, steps=steps, prefill_ms=prefill_ms,
                   prefill_tokens_per_s=b * s0 / prefill_ms * 1e3, decode_step_ms=step_ms,
                   decode_step_ms_median=step_med, decode_tokens_per_s=b / step_med * 1e3,
                   peak_bytes=peak, k7_launches=k7_prefill, counts=counts, card=card)
        if cfg.family == "xlstm":
            row["slstm_ms"] = timer.take("slstm")
            log(f"[families] {cfg.name}: the sLSTM time loops ({s0} steps, "
                f"{XL.block_kinds(cfg).count('s')} blocks) take {row['slstm_ms']:.2f} ms of "
                f"the prefill")
        log(f"[families] {cfg.name}: prefill {b}x{s0}"
            f"{f' (+{n_img} image tokens)' if n_img else ''}: {prefill_ms:.2f} ms "
            f"({row['prefill_tokens_per_s']:.0f} tokens/s); decode step median {step_med:.2f} "
            f"ms (min {min(step_ms):.2f}, max {max(step_ms):.2f}); peak memory "
            f"{peak / 2**30:.2f} GiB; K7 {k7_prefill} launches | {card}")

        row["k7_share"] = None
        if want:     # K7's share of the prefill's device time
            prof = profiled(torch, f"{cfg.name}: one more prefill",
                            lambda: bundle.prefill(model, batch, max_len=max_len))
            k7_ms = sum(t for key, t in prof["by_name"].items()
                        if "flash_attention_wgmma" in key or "flash_attention_kernel" in key)
            row["profile"] = dict(wall_ms=prof["wall_ms"],
                                  device_busy_ms=prof["device_busy_ms"], k7_ms=k7_ms,
                                  top=prof["top"])
            if prof["device_busy_ms"] > 0:
                row["k7_share"] = k7_ms / prof["device_busy_ms"]
                log(f"[families] {cfg.name}: K7 takes {k7_ms:.2f} ms of the prefill's "
                    f"{prof['device_busy_ms']:.2f} ms device time: share "
                    f"{row['k7_share']:.3f}")
            del prof
        dprof = profiled(torch, f"{cfg.name}: one more decode step at batch {b}",
                         lambda: bundle.decode_step(model, cache, {"token": toks[-1]}))
        row["decode_profile"] = dict(wall_ms=dprof["wall_ms"],
                                     device_busy_ms=dprof["device_busy_ms"], top=dprof["top"])
        row["decode_idle_share"] = (1 - dprof["device_busy_ms"] / dprof["wall_ms"]
                                    if dprof["device_busy_ms"] > 0 else None)
        del model, cache, logits, dprof
        gc.collect()
        torch.cuda.empty_cache()

        # float32 checks at full width and cut depth
        cfg32 = dataclasses.replace(get_arch(name), dtype="float32",
                                    **FAMILY_CHECK_CUT[cfg.family])
        b32 = model_zoo.get_model(cfg32)
        m32 = b32.init(seed=0, device=dev)
        routes_a, routes_b = [], []
        rec = cfg32.family == "moe"
        with recorded_routes(routes_a) if rec else contextlib.nullcontext():
            la, ca = b32.prefill(m32, batch, max_len=max_len)
        if model_zoo.k7_prefill_launches(cfg32):
            with mock.patch.object(MA, "flash_attention", plain_k7), \
                    recorded_routes(routes_b) if rec else contextlib.nullcontext():
                lb, _ = b32.prefill(m32, batch, max_len=max_len)
            row["check_a_rel_err"] = rel_err(la, lb)
            if rec:
                # a token whose top-k experts are near a tie goes to other experts
                # when the attention before it moves by a float32 rounding, and
                # its logits then move by far more than 1e-4. So the logits are
                # held on the same experts (the plain run takes the K7 run's
                # choices and its own weights at them), and so are the router's
                # probabilities; and every token that either plain run would
                # route differently from the K7 run, where the layers before
                # routed alike (every layer of the forced run, the free run's
                # first layer that differs), must be one at which the K7 run's
                # router was within the same tolerance of a tie. The free run's
                # later differences follow from those and are counted.
                row["check_a_rel_err_free_routing"] = row["check_a_rel_err"]
                row["check_a_routing_diffs"] = sum(int((ra[1] != rb[1]).any(-1).sum())
                                                   for ra, rb in zip(routes_a, routes_b))
                routes_f = []
                with mock.patch.object(MA, "flash_attention", plain_k7), \
                        forced_routes(routes_a, routes_f):
                    lb, _ = b32.prefill(m32, batch, max_len=max_len)
                row["check_a_rel_err"] = rel_err(la, lb)
                row["check_a_router_rel_err"] = max(
                    float(((pa - pf).abs().amax(-1) / pa.amax(-1)).max())
                    for (pa, _), (pf, _) in zip(routes_a, routes_f))
                forced = [flips(pa, ea, ef) for (pa, ea), (_, ef) in zip(routes_a, routes_f)]
                first = next(((ra, rb) for ra, rb in zip(routes_a, routes_b)
                              if bool((ra[1] != rb[1]).any())), None)
                free = flips(first[0][0], first[0][1], first[1][1]) if first else flips(
                    routes_a[0][0], routes_a[0][1], routes_a[0][1])
                row["check_a_flips"] = dict(
                    forced_tokens=[f["tokens"] for f in forced],
                    forced_margin=max(f["margin"] for f in forced),
                    forced_margin_ulps=max(f["margin_ulps"] for f in forced),
                    free_first_layer=free)
            log(f"[families check a] {cfg32.name}, float32, {cfg32.n_layers} layers: prefill "
                f"logits with K7 vs its plain version: max |diff| / max |logit| = "
                f"{row['check_a_rel_err']:.3g}"
                + (f" on the same experts; with free routing "
                   f"{row['check_a_rel_err_free_routing']:.3g}, tokens routed differently "
                   f"(over the layers) {row['check_a_routing_diffs']}" if rec else ""))
            if rec:
                fl = row["check_a_flips"]
                log(f"[families check a] {cfg32.name}: router probabilities on the same "
                    f"experts: max |diff| / the row's largest = "
                    f"{row['check_a_router_rel_err']:.3g}; tokens the plain router would route "
                    f"differently, a layer {fl['forced_tokens']}, the K7 router's largest "
                    f"margin to a tie among them {fl['forced_margin']:.3g} of the row's largest "
                    f"probability ({fl['forced_margin_ulps']:.1f} ulps of it); the free run's "
                    f"first layer that differs: {fl['free_first_layer']['tokens']} tokens, "
                    f"margin {fl['free_first_layer']['margin']:.3g} "
                    f"({fl['free_first_layer']['margin_ulps']:.1f} ulps)")
                worst = max(row["check_a_router_rel_err"], fl["forced_margin"],
                            fl["free_first_layer"]["margin"])
                if not worst <= FAMILY_REL_TOL:
                    raise AssertionError(
                        f"{cfg32.name} check (a): the router's probabilities on the same "
                        f"experts ({row['check_a_router_rel_err']:.3g}) or a routing "
                        f"difference's margin to a tie ({fl['forced_margin']:.3g}, free run "
                        f"{fl['free_first_layer']['margin']:.3g}) > {FAMILY_REL_TOL}")
            if not row["check_a_rel_err"] <= FAMILY_REL_TOL:
                raise AssertionError(f"{cfg32.name} check (a): {row['check_a_rel_err']:.3g} "
                                     f"> {FAMILY_REL_TOL}")
            del lb
        dec_logits, dtoks = [], [greedy(la)]
        for _ in range(steps):
            la, ca = b32.decode_step(m32, ca, {"token": dtoks[-1]})
            dec_logits.append(la)
            dtoks.append(greedy(la))
        err_b = {}
        for t in sorted({1, max(1, steps // 2), steps}):
            full = torch.cat([tokens, torch.stack(dtoks[:t], 1)], 1)
            lf, _ = b32.prefill(m32, {**batch, "tokens": full})
            err_b[t] = rel_err(dec_logits[t - 1], lf)
            log(f"[families check b] {cfg32.name}: decode step {t} logits vs a prefill over "
                f"the prompt + {t} decoded tokens: {err_b[t]:.3g}")
        row["check_b_rel_err"] = err_b
        if not max(err_b.values()) <= FAMILY_REL_TOL:
            raise AssertionError(f"{cfg32.name} check (b): {err_b} > {FAMILY_REL_TOL}")
        del m32, ca, la, dec_logits, routes_a, routes_b
        gc.collect()
        torch.cuda.empty_cache()
        row["seconds"] = time.perf_counter() - t_cfg
        log(f"[families] {cfg.name} took {row['seconds']:.1f} s")
        rows.append(row)
    return {"configs": rows, "counts": path_counts}


TRAIN_ARCH = "qwen2.5-3b"    # phase 15 (a): as published, bf16, remat on
TRAIN_SEQ = 4096             # (a): tokens a step (train_4k's length) ...
TRAIN_BATCH = 1              # ... at batch 1 (train_4k's global batch is 256)
TRAIN_STEPS = 5              # (a): timed steps, after one warm-up step
TRAIN_LR = 3e-4              # (a): AdamW's peak rate, no warmup
TRAIN_CHECK_LAYERS = 4       # (b): float32 depth at full width
GEMMA_TRAIN_ARCH = "gemma3-4b"   # (d): as published (head dim 320), bf16, remat on, (a)'s tokens
GEMMA_TRAIN_STEPS = 3        # (d): timed steps, after one warm-up step
TRAIN_REL_TOL = 1e-4         # (b): of each leaf's largest |grad|
# (c): every family at reduced float32 size through the Trainer
TRAIN_FAMILIES = (("qwen2.5-3b", {}), ("granite-moe-1b-a400m", {}),
                  ("seamless-m4t-medium", {}), ("paligemma-3b", {}), ("zamba2-2.7b", {}),
                  ("xlstm-350m", dict(n_layers=7)))
TRAINER_COMPRESSED = "zamba2-2.7b"   # (c): the config that trains with int8 gradients
TRAINER_STEPS, TRAINER_EVERY, TRAINER_FAULT = 20, 10, 15
TRAINER_BATCH, TRAINER_SEQ = 4, 128


def model_flops(cfg, n_params: int, embed_params: int, b: int, s: int) -> float:
    """Model FLOPs of one train step (PaLM's count, no remat recompute):
    6 per token per parameter outside the embedding table (the unembed
    counts), plus 12·layers·heads·head_dim·S per token for the attention
    scores and their product with V (the causal half not subtracted)."""
    return b * s * (6.0 * (n_params - embed_params)
                    + 12.0 * cfg.n_layers * cfg.n_heads * cfg.hd * s)


@contextlib.contextmanager
def grad_check(torch, n_params: int, out: list):
    """Record, for each `torch.autograd.grad` call inside that returns
    `n_params` gradients (the train step's; K7's backward returns three),
    whether each is finite and non-zero: one flag a parameter."""
    real = torch.autograd.grad

    def grad(*a, **kw):
        gs = real(*a, **kw)
        if len(gs) == n_params:
            out.append(torch.stack([torch.isfinite(g).all() & (g != 0).any()
                                    for g in gs]).cpu())
        return gs

    with mock.patch.object(torch.autograd, "grad", grad):
        yield


def train_full(torch, dev, card: str, cfg, steps: int, label: str, counts_into: dict) -> dict:
    """Phase 15 (a) or (d): `cfg` at full width through `make_train_step`
    with AdamW, bf16 and remat as configured, TRAIN_BATCH x TRAIN_SEQ tokens:
    a warm-up step with every gradient checked finite and non-zero, `steps`
    timed steps (the losses must fall; K7 and its backward launched the
    config's count each step) and one profiled step (the device's busy and
    idle share, the attention backward's share). Adds the timed steps'
    launch counts to `counts_into`; returns the record."""
    from repro_torch import kernels as K
    from repro_torch.data.tokens import DataConfig, SyntheticTokens
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import model_zoo
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import make_train_step

    bundle = model_zoo.get_model(cfg)
    t0 = time.perf_counter()
    model = bundle.init(seed=0, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    flops = model_flops(cfg, n_params, model.embed.numel(), TRAIN_BATCH, TRAIN_SEQ)
    want = model_zoo.k7_train_launches(cfg)
    want_bwd = model_zoo.k7_backward_launches(cfg)
    log(f"[train] ({label}) {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, vocab "
        f"{cfg.vocab}, {cfg.dtype}, remat {cfg.remat}; {n_params} parameters from seed 0 in "
        f"{time.perf_counter() - t0:.1f} s; {TRAIN_BATCH} x {TRAIN_SEQ} tokens a step; "
        f"model FLOPs a step {flops:.4g}")
    source = SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                        global_batch=TRAIN_BATCH, seed=0))
    step = make_train_step(bundle, opt.OptimizerConfig(lr=TRAIN_LR, warmup_steps=0,
                                                       total_steps=1000))
    state = opt.init(dict(model.named_parameters()))
    losses, step_ms, per_step, bwd_per_step, flags = [], [], [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n_tensors = len(list(model.parameters()))
    with grad_check(torch, n_tensors, flags):   # the warm-up step: every gradient checked
        model, state, _e, met = step(model, state, None, source.batch(0))
        losses.append(float(met["loss"]))
    log(f"[train] ({label}) warm-up step (every gradient checked) done at "
        f"{time.perf_counter() - t0:.1f} s")
    bad = [n for (n, _p), ok in zip(model.named_parameters(), flags[0]) if not ok]
    if bad:
        raise AssertionError(f"{cfg.name}: {len(bad)} parameters got a zero or non-finite "
                             f"gradient, e.g. {bad[:5]}")
    K.reset_launch_counts()
    for i in range(1, steps + 1):
        batch = source.batch(i)
        before = (FA.flash_attention.launches, FA.flash_attention_backward.launches)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        model, state, _e, met = step(model, state, None, batch)
        losses.append(float(met["loss"]))      # waits for the card
        step_ms.append((time.perf_counter() - t1) * 1e3)
        per_step.append(FA.flash_attention.launches - before[0])
        bwd_per_step.append(FA.flash_attention_backward.launches - before[1])
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for key, n in counts.items():
        counts_into[key] += n
    med = statistics.median(step_ms)
    log(f"[train] ({label}) losses {[round(x, 4) for x in losses]}; K7 launches a step "
        f"{per_step}, "
        f"its backward's {bwd_per_step}")
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{cfg.name}: losses {losses} not finite or not falling")
    if per_step != [want] * steps:
        raise AssertionError(f"K7 launched {per_step} times a step, not {want}")
    if bwd_per_step != [want_bwd] * steps:
        raise AssertionError(f"K7's backward launched {bwd_per_step} times a step, not "
                             f"{want_bwd}")
    full = dict(arch=cfg.name, layers=cfg.n_layers, dtype=cfg.dtype, remat=cfg.remat,
                params=n_params, batch=TRAIN_BATCH, seq=TRAIN_SEQ, losses=losses,
                step_ms=step_ms, step_ms_median=med,
                tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / med * 1e3,
                model_flops=flops, mfu=flops / (med * 1e-3) / BF16_OPS_PER_S,
                peak_bytes=peak, k7_launches_per_step=per_step,
                k7_backward_launches_per_step=bwd_per_step, card=card)
    log(f"[train] ({label}) step median {med:.2f} ms (min {min(step_ms):.2f}, max "
        f"{max(step_ms):.2f}); "
        f"{full['tokens_per_s']:.0f} tokens/s; MFU {full['mfu']:.4f} of "
        f"{BF16_OPS_PER_S / 1e12:.0f} TFLOP/s bf16; peak memory {peak / 2**30:.2f} GiB | {card}")

    # one profiled step (kernels only: a step launches about 10^5 of them, and
    # the host ops' events would take the profiler minutes to sort): its
    # kernels' device time over the unprofiled median step is the device's
    # busy share, and the attention backward's kernels' share of that time
    # is read from the same trace
    from torch.profiler import ProfilerActivity, profile
    t1 = time.perf_counter()
    batch = source.batch(steps + 1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t2 = time.perf_counter()
        step(model, state, None, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t2) * 1e3
    kernels = {ev.key: ev.self_device_time_total / 1e3 for ev in prof.key_averages()
               if ev.self_device_time_total > 0}
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    bwd = {key: t for key, t in kernels.items() if "attention_bwd" in key}
    fwd = {key: t for key, t in kernels.items() if "flash_attention_" in key}
    bwd_ms, fwd_ms = sum(bwd.values()), sum(fwd.values())
    full["profile"] = dict(wall_ms=wall, device_busy_ms=busy, top=top,
                           attention_backward_ms=bwd_ms, attention_backward_kernels=bwd,
                           attention_backward_calls=want_bwd, attention_forward_ms=fwd_ms,
                           seconds=time.perf_counter() - t1)
    full["idle_share"] = 1 - busy / med if busy > 0 else None
    full["attention_backward_share"] = bwd_ms / busy if busy > 0 else None
    log(f"[train] ({label}) profiled step: device busy {busy:.2f} ms (wall {wall:.2f} ms with the "
        f"profiler on); idle share of the unprofiled median step "
        f"{fmt_share(full['idle_share'])}; the attention backward's kernels "
        f"{bwd_ms:.2f} device ms in {want_bwd} calls ({bwd_ms / want_bwd:.3f} a call), share "
        f"of device time {fmt_share(full['attention_backward_share'])}; K7's forward "
        f"{fwd_ms:.2f} ms; profiling took {full['profile']['seconds']:.1f} s")
    for name, t in top:
        log(f"[profile]   {t:9.3f} ms  {name[:90]}")
    if busy > 0 and not bwd:
        raise AssertionError(f"phase 15 ({label}): the profiled step shows no backward "
                             f"kernel")
    del model, state, met, prof
    gc.collect()
    torch.cuda.empty_cache()

    full["seconds"] = time.perf_counter() - t0
    log(f"[train] ({label}) took {full['seconds']:.1f} s")
    return full


def lm_train(torch, dev, card: str) -> dict:
    """Phase 15: training on the card. (a) qwen2.5-3b as published through
    `make_train_step`; (d) gemma3-4b likewise (K7 and its backward at head
    dim 320 on wgmma); (b) float32 gradients at full width, K7 against
    `attention_plain`; (c) every family at reduced size through the
    `Trainer`, one injected fault each. Returns the phase's report, with the
    launch counts of (a)'s and (d)'s timed steps and (c)'s runs under
    "counts"."""
    import shutil
    import tempfile
    from repro_torch import kernels as K
    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import DataConfig, SyntheticTokens
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import attention as MA
    from repro_torch.models import model_zoo
    from repro_torch.models.config import reduced
    from repro_torch.train import optimizer as opt
    from repro_torch.train.trainer import Trainer, TrainerConfig

    out, path_counts = {}, {name: 0 for name in K.launch_counts()}

    # (a) full width ---------------------------------------------------------------
    out["full"] = train_full(torch, dev, card, get_arch(TRAIN_ARCH), TRAIN_STEPS, "a",
                             path_counts)

    # (d) gemma3-4b at full width: K7's backward at head dim 320 on the step ----------
    gcfg = get_arch(GEMMA_TRAIN_ARCH)
    rt = FA.bwd_route(gcfg.hd, torch.bfloat16)
    log(f"[train] (d) {gcfg.name}: K7's backward at head dim {gcfg.hd} on route {rt.route}, "
        f"bucket {rt.d_pad}, dQ pass blocks {rt.dq_blocks}, dK/dV pass blocks "
        f"{rt.dkv_blocks}")
    ft = FA.fwd_route(gcfg.hd, torch.bfloat16)
    if (rt.route, rt.d_pad, ft.route, ft.d_pad) != ("wgmma", 320, "wgmma", 320):
        raise AssertionError(f"phase 15 (d): K7 at head dim {gcfg.hd} on {ft}, its backward "
                             f"on {rt}")
    out["gemma3"] = train_full(torch, dev, card, gcfg, GEMMA_TRAIN_STEPS, "d", path_counts)
    out["gemma3"].update(k7_backward_route=rt.route,
                         k7_backward_d_pad=rt.d_pad,
                         k7_forward_route=ft.route, k7_forward_d_pad=ft.d_pad)
    cfg = get_arch(TRAIN_ARCH)
    source = SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                        global_batch=TRAIN_BATCH, seed=0))
    t0 = time.perf_counter()

    # (b) float32 at full width, TRAIN_CHECK_LAYERS layers: K7 vs attention_plain --
    def serving_plain(q, k, v, *, causal, window):
        t = (lambda x: x.transpose(1, 2))
        return t(MA.attention_plain(t(q), t(k), t(v), causal=causal, window=window))

    cfg32 = dataclasses.replace(cfg, n_layers=TRAIN_CHECK_LAYERS, dtype="float32")
    b32 = model_zoo.get_model(cfg32)
    m32 = b32.init(seed=0, device=dev)
    batch = {k: v.to(dev) for k, v in source.batch(0).items()}
    names, params = zip(*m32.named_parameters())
    runs = []
    before = FA.flash_attention_backward.launches
    for sub in (contextlib.nullcontext(), mock.patch.object(MA, "flash_attention",
                                                            serving_plain)):
        with sub:
            loss = b32.loss(m32, batch)
            runs.append((loss.detach(), torch.autograd.grad(loss, params)))
    n_bwd = FA.flash_attention_backward.launches - before
    if n_bwd != model_zoo.k7_backward_launches(cfg32):
        raise AssertionError(f"phase 15 (b): K7's backward launched {n_bwd} times, not "
                             f"{model_zoo.k7_backward_launches(cfg32)}")
    loss_gap = abs(float(runs[0][0]) - float(runs[1][0])) / abs(float(runs[1][0]))
    errs = {n: rel_err(a, b) for n, a, b in zip(names, runs[0][1], runs[1][1])}
    worst = max(errs, key=errs.get)
    out["check"] = dict(layers=TRAIN_CHECK_LAYERS, seq=TRAIN_SEQ, loss_rel_gap=loss_gap,
                        grad_rel_err_max=errs[worst], worst=worst, k7_backward_launches=n_bwd)
    log(f"[train check] float32, {TRAIN_CHECK_LAYERS} layers, {TRAIN_SEQ} tokens: loss with K7 "
        f"vs attention_plain {loss_gap:.3g}; gradients max |diff| / max |grad| {errs[worst]:.3g}"
        f" ({worst}); K7's backward launched {n_bwd} times")
    if not (loss_gap <= TRAIN_REL_TOL and errs[worst] <= TRAIN_REL_TOL):
        raise AssertionError(f"phase 15 (b): {loss_gap:.3g} / {errs[worst]:.3g} > "
                             f"{TRAIN_REL_TOL}")
    del m32, runs, params, loss
    gc.collect()
    torch.cuda.empty_cache()
    out["check"]["seconds"] = time.perf_counter() - t0
    log(f"[train] (b) took {out['check']['seconds']:.1f} s")

    # (c) every family at reduced float32 size through the Trainer ----------------
    rows = []
    for name, over in TRAIN_FAMILIES:
        rcfg = reduced(get_arch(name), **over)
        rb = model_zoo.get_model(rcfg)
        boom = {"armed": True}

        def hook(i):
            if i == TRAINER_FAULT and boom["armed"]:
                boom["armed"] = False
                raise RuntimeError("injected node failure")

        workdir = tempfile.mkdtemp(prefix="nebula_train_")
        flags = []
        try:
            trainer = Trainer(
                rb, opt.OptimizerConfig(lr=3e-3, warmup_steps=5, total_steps=TRAINER_STEPS),
                TrainerConfig(total_steps=TRAINER_STEPS, checkpoint_every=TRAINER_EVERY,
                              checkpoint_dir=workdir,
                              compress_grads=name == TRAINER_COMPRESSED),
                DataConfig(vocab=rcfg.vocab, seq_len=TRAINER_SEQ, global_batch=TRAINER_BATCH),
                step_hook=hook, device=dev)
            K.reset_launch_counts()
            t1 = time.perf_counter()
            n_tensors = len(list(rb.init(seed=0, device="cpu").parameters()))
            with grad_check(torch, n_tensors, flags):
                res = trainer.run(resume=False)
            seconds = time.perf_counter() - t1
            counts = K.launch_counts()
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        for key, n in counts.items():
            path_counts[key] += n
        hist = res["history"]
        first = statistics.mean(h["loss"] for h in hist[:5])
        last = statistics.mean(h["loss"] for h in hist[-5:])
        k7_want = model_zoo.k7_train_launches(rcfg) * len(hist)
        bwd_want = model_zoo.k7_backward_launches(rcfg) * len(hist)
        all_grads = bool(torch.stack([f.all() for f in flags]).all())
        row = dict(arch=rcfg.name, family=rcfg.family, layers=rcfg.n_layers,
                   compress_grads=name == TRAINER_COMPRESSED, steps_run=len(hist),
                   restarts=res["restarts"], final_step=res["final_step"],
                   loss_first5=first, loss_last5=last,
                   step_ms_median=statistics.median(h["time"] for h in hist[3:]) * 1e3,
                   k7_launches=counts["flash_attention"], k7_want=k7_want,
                   k7_backward_launches=counts["flash_attention_backward"],
                   k7_backward_want=bwd_want, every_grad_nonzero=all_grads, seconds=seconds)
        rows.append(row)
        log(f"[train] Trainer {rcfg.name} ({rcfg.family}{', int8 grads' if row['compress_grads'] else ''}): "
            f"{len(hist)} steps, restarts {res['restarts']}, loss {first:.4f} -> {last:.4f}, "
            f"step median {row['step_ms_median']:.1f} ms, K7 {counts['flash_attention']} "
            f"(want {k7_want}), its backward {counts['flash_attention_backward']} (want "
            f"{bwd_want}), {seconds:.1f} s")
        if not (res["restarts"] == 1 and res["final_step"] == TRAINER_STEPS
                and all(math.isfinite(h["loss"]) for h in hist) and last < first
                and all_grads and counts["flash_attention"] == k7_want
                and counts["flash_attention_backward"] == bwd_want):
            raise AssertionError(f"phase 15 (c) {rcfg.name}: {row}")
        del trainer, res
        gc.collect()
        torch.cuda.empty_cache()
    out["trainer"] = rows
    out["counts"] = path_counts
    return out


LM_MESH_STEPS = 8            # phase 16 (a): greedy decode steps (phase 9's prefill)
LM_MESH_TRAIN_STEPS = 2      # (a): train steps a run, meshed and meshless
# (b): dry-run cells, each in a process of its own with a fake world
DRYRUN_CELLS = (("qwen2.5-3b", "train_4k", "single"), ("qwen2.5-3b", "prefill_32k", "single"),
                ("qwen2.5-3b", "decode_32k", "single"), ("qwen2.5-3b", "train_4k", "multi"),
                ("qwen2.5-3b", "prefill_32k", "multi"), ("qwen2.5-3b", "decode_32k", "multi"),
                ("granite-moe-1b-a400m", "train_4k", "single"))
DRYRUN_WAIT_S = 420          # (b), (c): the longest the phase waits on a dry-run process
HBM_GB = 80.0                # the card's memory, against each cell's per-device bytes

_DRYRUN_1X1 = r"""
import json, sys
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import init_fake_world, make_mesh
from repro_torch.models.config import ShapeConfig
init_fake_world(1)
rec = dryrun.trace_cell(sys.argv[1], ShapeConfig("train", int(sys.argv[2]), int(sys.argv[3]),
                                                 "train"), make_mesh((1, 1), ("data", "model")))
print(json.dumps(rec))
"""


def start_dryruns(workdir: Path) -> dict:
    """Phase 16 (b) and (c)'s processes, all started at once (no card: each
    traces on the meta device in a fake world of its own)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    procs = {}
    for arch, shape, mesh in DRYRUN_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
               shape, "--mesh", mesh, "--out", str(workdir), "--force"]
        log_f = open(workdir / f"{arch}__{shape}__{mesh}.log", "w")
        procs[(arch, shape, mesh)] = (subprocess.Popen(cmd, env=env, stdout=log_f,
                                                       stderr=subprocess.STDOUT), log_f)
    out_f = open(workdir / "dryrun_1x1.json", "w")
    procs["1x1"] = (subprocess.Popen([sys.executable, "-c", _DRYRUN_1X1, TRAIN_ARCH,
                                      str(TRAIN_SEQ), str(TRAIN_BATCH)], env=env,
                                     stdout=out_f, stderr=subprocess.DEVNULL), out_f)
    return procs


def wait_dryruns(procs: dict) -> dict:
    """Wait for every process of `start_dryruns`; kill any still running at
    the deadline. → {key: return code (None when killed)}."""
    deadline = time.perf_counter() + DRYRUN_WAIT_S
    codes = {}
    for key, (p, f) in procs.items():
        try:
            codes[key] = p.wait(timeout=max(1.0, deadline - time.perf_counter()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            codes[key] = None
        f.close()
    return codes


def lm_mesh(torch, dev, card: str, train: dict) -> dict:
    """Phase 16: (a) qwen2.5-3b on a 1x1 NCCL mesh against the meshless
    model, (b) the production dry-run cells, (c) the 1x1 dry-run of phase
    15 (a)'s train step against the card. Returns the phase's report, with
    the launch counts of (a)'s meshed runs under "counts"."""
    import shutil
    import tempfile
    from repro_torch import kernels as K
    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import DataConfig, SyntheticTokens
    from repro_torch.launch.mesh import destroy_fleet_group, init_fleet_group, make_mesh
    from repro_torch.models import model_zoo
    from repro_torch.models.layers import param_axes
    from repro_torch.sharding.context import activation_rules, meshed
    from repro_torch.sharding.partitioning import (LOGICAL_RULES, make_shardings,
                                                   shard_module, shard_tree)
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import make_train_step

    cfg = get_arch(LM_ARCH)
    bundle = model_zoo.get_model(cfg)
    out, path_counts = {}, {name: 0 for name in K.launch_counts()}
    workdir = Path(tempfile.mkdtemp(prefix="nebula_dryrun_"))

    def local(t):
        return t.to_local() if hasattr(t, "to_local") else t

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    def greedy(logits):
        return local(logits)[:, :cfg.vocab].argmax(-1)

    try:
        init_fleet_group(str(workdir / "store"), 0, 1, "nccl", device=dev)
        mesh = make_mesh((1, 1), ("data", "model"), device=dev)
        rules = activation_rules(mesh)

        def place_batch(batch):
            axes = {k: ("batch",) + (None,) * (v.ndim - 1) for k, v in batch.items()}
            return shard_tree(batch, mesh, make_shardings(mesh, batch, axes, dict(LOGICAL_RULES)))

        # (a) serving: phase 9's prefill and LM_MESH_STEPS greedy steps, the
        # meshless model first, then the same weights placed on the mesh
        b, s0, steps = LM_BATCH, LM_PROMPT, LM_MESH_STEPS
        max_len = s0 + steps
        gen = torch.Generator(device=dev).manual_seed(1)
        tokens = torch.randint(0, cfg.vocab, (b, s0), generator=gen, device=dev)
        model = bundle.init(seed=0, device=dev)

        def serve(m, batch, place=lambda t: t):
            (logits, cache), pre_ms = timed(lambda: bundle.prefill(m, batch, max_len=max_len))
            seq, step_ms = [local(logits).clone()], []
            tok = greedy(logits)
            toks = [tok]
            for _ in range(steps):
                (logits, cache), ms = timed(
                    lambda: bundle.decode_step(m, cache, {"token": place(tok)}))
                seq.append(local(logits).clone())
                tok = greedy(logits)
                toks.append(tok)
                step_ms.append(ms)
            return seq, torch.stack(toks, 1), pre_ms, step_ms

        serve(model, {"tokens": tokens})                      # warm-up, not compared
        ref_logits, ref_toks, pre_plain, steps_plain = serve(model, {"tokens": tokens})
        specs = make_shardings(mesh, dict(model.named_parameters()), param_axes(model))
        shard_module(model, mesh, specs)

        def place_tok(t):
            return place_batch({"token": t})["token"]

        with meshed(rules):
            serve(model, place_batch({"tokens": tokens}), place_tok)      # warm-up
            K.reset_launch_counts()
            got_logits, got_toks, pre_mesh, steps_mesh = serve(
                model, place_batch({"tokens": tokens}), place_tok)
            counts = K.launch_counts()
        for key, n in counts.items():
            path_counts[key] += n
        if counts["flash_attention"] != cfg.n_layers:
            raise AssertionError(f"phase 16 (a): K7 launched {counts['flash_attention']} times "
                                 f"in a meshed prefill, not {cfg.n_layers}")
        same = [torch.equal(a, b_) for a, b_ in zip(got_logits, ref_logits)]
        gap = max(float((a.float() - b_.float()).abs().max()) for a, b_ in
                  zip(got_logits, ref_logits))
        scale = max(float(b_.float().abs().max()) for b_ in ref_logits)
        tok_same = bool(torch.equal(got_toks, ref_toks))
        log(f"[lm_mesh] (a) serving on a 1x1 mesh: logits bit for bit {all(same)} "
            f"(prefill and {steps} steps; max gap {gap:.3g} of {scale:.3g}), greedy tokens "
            f"equal {tok_same}; K7 {counts['flash_attention']} launches in the prefill")
        if not (all(same) and tok_same) and gap > LM_REL_TOL * scale:
            raise AssertionError(f"phase 16 (a): meshed logits {gap:.3g} from the meshless "
                                 f"ones, above {LM_REL_TOL} of {scale:.3g}")
        out["serve"] = dict(bitwise=all(same), tokens_equal=tok_same, max_abs_gap=gap,
                            scale=scale, prefill_ms_meshless=pre_plain, prefill_ms_meshed=pre_mesh,
                            decode_ms_meshless=statistics.median(steps_plain),
                            decode_ms_meshed=statistics.median(steps_mesh),
                            k7_prefill=counts["flash_attention"])
        log(f"[lm_mesh] (a) prefill {b}x{s0}: meshless {pre_plain:.2f} ms, meshed "
            f"{pre_mesh:.2f} ms; decode step median meshless "
            f"{out['serve']['decode_ms_meshless']:.2f} ms, meshed "
            f"{out['serve']['decode_ms_meshed']:.2f} ms | {card}")
        del model, ref_logits, got_logits
        gc.collect()
        torch.cuda.empty_cache()

        # (a) training: phase 15 (a)'s step, meshless then meshed, from seed 0
        tcfg = get_arch(TRAIN_ARCH)
        tbundle = model_zoo.get_model(tcfg)
        source = SyntheticTokens(DataConfig(vocab=tcfg.vocab, seq_len=TRAIN_SEQ,
                                            global_batch=TRAIN_BATCH, seed=0))
        ocfg = opt.OptimizerConfig(lr=TRAIN_LR, warmup_steps=0, total_steps=1000)
        step = make_train_step(tbundle, ocfg)
        want = (model_zoo.k7_train_launches(tcfg), model_zoo.k7_backward_launches(tcfg))

        def run_steps(m, state, place=lambda bt: bt):
            losses, ms, per_step = [], [], []
            for i in range(LM_MESH_TRAIN_STEPS):
                batch = place({k: v.to(dev) for k, v in source.batch(i).items()})
                before = K.launch_counts()
                (res, t) = timed(lambda: step(m, state, None, batch))
                m, state, _e, met = res
                losses.append(local(met["loss"]).clone())
                ms.append(t)
                after = K.launch_counts()
                per_step.append(tuple(after[key] - before[key] for key in
                                      ("flash_attention", "flash_attention_backward")))
            return losses, ms, per_step

        gc.collect()
        torch.cuda.empty_cache()
        def requested():
            return torch.cuda.memory_stats().get("requested_bytes.all.current", 0)

        m0, r0 = torch.cuda.memory_allocated(), requested()
        tmodel = tbundle.init(seed=0, device=dev)
        state = opt.init(dict(tmodel.named_parameters()))
        torch.cuda.synchronize()
        measured = torch.cuda.memory_allocated() - m0
        asked = requested() - r0
        raw = sum(p.numel() * (p.element_size() + 8) for p in tmodel.parameters())
        ref_losses, ms_plain, _ = run_steps(tmodel, state)
        del tmodel, state
        gc.collect()
        torch.cuda.empty_cache()
        tmodel = tbundle.init(seed=0, device=dev)
        tspecs = make_shardings(mesh, dict(tmodel.named_parameters()), param_axes(tmodel))
        shard_module(tmodel, mesh, tspecs)
        zeros = {n: torch.zeros(p.shape, dtype=torch.float32, device=dev)
                 for n, p in tmodel.named_parameters()}
        state = opt.AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                               m=shard_tree(zeros, mesh, tspecs),
                               v=shard_tree({n: z.clone() for n, z in zeros.items()}, mesh,
                                            tspecs))
        del zeros
        with meshed(rules):
            K.reset_launch_counts()
            got_losses, ms_mesh, per_step = run_steps(tmodel, state, place_batch)
            counts = K.launch_counts()
        for key, n in counts.items():
            path_counts[key] += n
        del tmodel, state
        gc.collect()
        torch.cuda.empty_cache()
        same = [torch.equal(a, b_) for a, b_ in zip(got_losses, ref_losses)]
        loss_gap = max(float((a - b_).abs()) for a, b_ in zip(got_losses, ref_losses))
        log(f"[lm_mesh] (a) train {TRAIN_BATCH}x{TRAIN_SEQ}: losses meshless "
            f"{[float(x) for x in ref_losses]}, meshed {[float(x) for x in got_losses]} (bit "
            f"for bit {all(same)}); K7 and its backward a meshed step {per_step}; step ms meshless "
            f"{[round(x, 2) for x in ms_plain]}, meshed {[round(x, 2) for x in ms_mesh]} | {card}")
        if per_step != [want] * LM_MESH_TRAIN_STEPS:
            raise AssertionError(f"phase 16 (a): K7 and its backward launched {per_step} times "
                                 f"a meshed step, not {want}")
        if not all(same) and loss_gap > LM_REL_TOL * max(abs(float(x)) for x in ref_losses):
            raise AssertionError(f"phase 16 (a): meshed losses {loss_gap:.3g} from the meshless")
        out["train"] = dict(bitwise=all(same), loss_gap=loss_gap,
                            losses_meshless=[float(x) for x in ref_losses],
                            losses_meshed=[float(x) for x in got_losses],
                            step_ms_meshless=ms_plain, step_ms_meshed=ms_mesh,
                            k7_per_step=per_step, param_moment_bytes=raw,
                            allocated_bytes=measured, requested_bytes=asked)
    finally:
        destroy_fleet_group()

    # (b) and (c): the dry-run processes, after (a)'s timings
    t0 = time.perf_counter()
    procs = start_dryruns(workdir)
    codes = wait_dryruns(procs)
    wall = time.perf_counter() - t0
    cells = []
    try:
        for (arch, shape, mesh_kind) in DRYRUN_CELLS:
            path = workdir / f"{arch}__{shape}__{mesh_kind}.json"
            rec = json.loads(path.read_text()) if path.exists() else {}
            if rec.get("status") != "ok" and "traceback" in rec:
                raise AssertionError(f"phase 16 (b): {arch} {shape} {mesh_kind}: "
                                     f"{rec['traceback'][-1500:]}")
            if codes[(arch, shape, mesh_kind)] != 0 or not rec:
                tail = (workdir / f"{arch}__{shape}__{mesh_kind}.log").read_text()[-1500:]
                raise AssertionError(f"phase 16 (b): {arch} {shape} {mesh_kind} ended with "
                                     f"{codes[(arch, shape, mesh_kind)]}: {tail}")
            if rec["status"] != "ok":
                raise AssertionError(f"phase 16 (b): {arch} {shape} {mesh_kind}: "
                                     f"{rec.get('error')} {rec.get('traceback', '')[-800:]}")
            mem = rec["memory"]
            gb = (mem["argument_bytes"] + mem["temp_bytes"] + mem["output_bytes"]) / 1e9
            coll = rec["collectives"]
            counts = {k[:-6]: int(v) for k, v in coll.items() if k.endswith("_count") and v}
            rf = rec["roofline"]
            log(f"[dryrun] {arch} {shape} {mesh_kind} ({rec['n_chips']} ranks): "
                f"{gb:.2f} GB a device of {HBM_GB:.0f} (arguments "
                f"{mem['argument_bytes'] / 1e9:.2f}, temporaries {mem['temp_bytes'] / 1e9:.2f}); "
                f"{rec['flops']:.4g} FLOPs, {rec['bytes_accessed']:.4g} B; collectives "
                f"{counts} {coll['collective_bytes']:.4g} B; roofline compute "
                f"{rf['compute_s']:.4g} s, memory {rf['memory_s']:.4g} s, collective "
                f"{rf['collective_s']:.4g} s: {rf['dominant']}; traced in {rec['trace_s']:.1f} s "
                f"(built in {rec['lower_s']:.1f} s)")
            cells.append(dict(arch=arch, shape=shape, mesh=mesh_kind, gb=gb,
                              **{k: rec[k] for k in ("n_chips", "memory", "flops",
                                                     "bytes_accessed", "collectives",
                                                     "roofline", "trace_s", "lower_s")}))
        out["dryrun"] = dict(cells=cells, wall_s=wall)
        log(f"[dryrun] (b) {len(cells)} cells ok in {wall:.1f} s of wall time, all at once")

        # (c) the 1x1 dry-run of phase 15 (a)'s step against the card
        if codes["1x1"] != 0:
            raise AssertionError(f"phase 16 (c): the 1x1 dry-run ended with {codes['1x1']}")
        rec = json.loads((workdir / "dryrun_1x1.json").read_text().strip().splitlines()[-1])
        batch_bytes = 2 * TRAIN_BATCH * TRAIN_SEQ * 4          # int32 tokens and targets
        dry = rec["memory"]["argument_bytes"] - batch_bytes - 4  # less the int32 step
        raw = out["train"]["param_moment_bytes"]
        measured, asked = out["train"]["allocated_bytes"], out["train"]["requested_bytes"]
        log(f"[dryrun] (c) 1x1 {TRAIN_ARCH} {TRAIN_BATCH}x{TRAIN_SEQ}: parameters and moments "
            f"{dry} B by the dry-run, {raw} B by the card's model, {asked - 4} B requested "
            f"from the allocator (its requested_bytes, less the step counter's 4); "
            f"memory_allocated grew by {measured} B, its blocks rounded up "
            f"({measured - asked} B more)")
        if not dry == raw == asked - 4:
            raise AssertionError(f"phase 16 (c): argument bytes {dry}, model {raw}, "
                                 f"requested {asked - 4}")
        peak_pred = rec["memory"]["argument_bytes"] + rec["memory"]["temp_bytes"]
        peak_meas = train.get("full", {}).get("peak_bytes")
        bound_s = max(rec["roofline"][k] for k in ("compute_s", "memory_s", "collective_s"))
        step_meas = train.get("full", {}).get("step_ms_median")
        log(f"[dryrun] (c) predicted peak {peak_pred / 2**30:.2f} GiB (arguments + "
            f"temporaries) against phase 15's measured {fmt_gib(peak_meas)}; roofline bound "
            f"{bound_s * 1e3:.2f} ms ({rec['roofline']['dominant']}) against the step's "
            f"{fmt_ms(step_meas)} measured in phase 15 and "
            f"{statistics.median(out['train']['step_ms_meshless']):.2f} ms here | {card}")
        out["dryrun_1x1"] = dict(argument_bytes=rec["memory"]["argument_bytes"],
                                 param_moment_bytes=dry, allocated_bytes=measured,
                                 predicted_peak_bytes=peak_pred, measured_peak_bytes=peak_meas,
                                 flops=rec["flops"], bytes_accessed=rec["bytes_accessed"],
                                 roofline=rec["roofline"], bound_ms=bound_s * 1e3,
                                 step_ms=step_meas, trace_s=rec["trace_s"])
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    out["counts"] = path_counts
    return out


def fmt_gib(x) -> str:
    return "not measured" if x is None else f"{x / 2**30:.2f} GiB"


def fmt_share(x) -> str:
    return "not measured" if x is None else f"{x:.3f}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--syncs", type=int, default=8, help="fleet syncs")
    ap.add_argument("--clients", type=int, default=8, help="fleet clients")
    ap.add_argument("--blocks", type=int, default=24)
    ap.add_argument("--out", type=str, default=None, help="also write the report here")
    ap.add_argument("--mesh-rank", type=int, default=None,
                    help="run as rank R of phase 13's four-rank mesh (the parent starts it)")
    ap.add_argument("--mesh-dir", type=str, default=None, help="phase 13's shared directory")
    ap.add_argument("--lm-mesh-only", action="store_true",
                    help="build the kernels and run phase 16 alone (a quick check of it)")
    ap.add_argument("--k7-device-ms", type=str, default=None, metavar="FILE",
                    help="write phase 10's K7 device times, measured in this process alone, "
                         "to FILE (phase 10 starts it)")
    args = ap.parse_args()
    if args.mesh_rank is not None:
        return mesh_rank_main(args.mesh_rank, args.mesh_dir)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from repro_torch import kernels as K
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 2
    from repro_torch.core import camera as C
    from repro_torch.core import gaussians as G
    from repro_torch.core import lod_search as LS
    from repro_torch.core import pipeline as P
    from repro_torch.core import binning as BN
    from repro_torch.core.binning import pair_spans
    from repro_torch.core.lod_tree import build_lod_tree
    from repro_torch.core.projection import depth_ranks
    from repro_torch.core import stereo
    from repro_torch.core.stereo import build_merge_sources
    from repro_torch.core import compression as CP
    from repro_torch.core import manager as MG
    from repro_torch.kernels import _build
    from repro_torch.kernels import binning as kbin
    from repro_torch.kernels import (lod_cut, preprocess, rasterize, sass, stereo_shift,
                                     vq_assign)
    from repro_torch import tracing
    from repro_torch import render as R
    from repro_torch.render import batched as RB
    from repro_torch.render import stages as RS
    from repro_torch.serve import delta_path as DP
    from repro_torch.serve import lod_service as SV

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card} | {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    report = {"card": card, "phases": {}}

    # 1. build ---------------------------------------------------------------
    b = _build.build()
    _build.library()
    log(f"[build] {b['seconds']:.1f} s, rebuilt={b['rebuilt']} -> {b['path']}")
    if args.k7_device_ms:
        Path(args.k7_device_ms).write_text(json.dumps(k7_device_times(torch, dev)))
        return 0
    report["ptxas"] = ptxas_report(b["ptxas"])
    for k in report["ptxas"]:
        log(f"[build] ptxas {k['kernel']}: {k['registers']} registers, {k['smem']} B static "
            f"shared memory, {k['spill_stores']} B spill stores, {k['spill_loads']} B spill "
            f"loads")
    for route in ("wgmma", "tf32x3"):   # K7's wgmma backward and every float32 kernel
        tc = [k for k in report["ptxas"] if route in k["kernel"]
              and (route == "tf32x3" or k["kernel"].startswith("attention_bwd"))]
        if not tc or any(k["spill_stores"] or k["spill_loads"] for k in tc):
            raise AssertionError(f"K7's {route} kernels missing from the build log, or "
                                 f"spilling: {tc}")
    report["phases"]["build_s"] = b["seconds"]
    # K2's SASS instructions a pixel-entry: the measure its design moves
    report["sass_k2"] = sass.report(b["path"], "rasterize_kernel")
    if not report["sass_k2"] or not all(row["loop"] for row in report["sass_k2"]):
        raise AssertionError(f"SASS of K2: no hot loop found in {report['sass_k2']}")
    for row in report["sass_k2"]:
        loop = row["loop"]
        log(f"[build] SASS {row['function']}: {row['instructions']} instructions; hot loop "
            f"{loop['instructions']} over {loop['ex2']} MUFU.EX2 = "
            f"{loop['per_ex2']:.2f} instructions a pixel-entry")

    if args.lm_mesh_only:
        lmm = lm_mesh(torch, dev, card, {})
        log(f"[lm_mesh] launches {json.dumps(lmm.pop('counts'))}")
        print(json.dumps(lmm, default=str))
        return 0

    # 2. scene, rigs, budgets --------------------------------------------------
    t0 = time.perf_counter()
    city = G.CityConfig(blocks_x=args.blocks, blocks_y=args.blocks, leaf_density=1.0, seed=2)
    leaves = G.generate_city(city, device=dev)
    tree = build_lod_tree(leaves, target_subtrees=1024, seed=0, device=dev)
    m = tree.meta
    build_s = time.perf_counter() - t0
    log(f"[scene] {args.blocks}x{args.blocks} blocks: {m.n_leaves} leaves, {m.n_real} real "
        f"nodes, {tree.n_pad} padded; T={m.T} Ns={m.Ns} S={m.S} slab depth "
        f"{m.slab_max_depth}; host build {build_s:.1f} s")
    report["scene"] = dict(blocks=args.blocks, leaves=m.n_leaves, n_real=m.n_real,
                           n_pad=tree.n_pad, T=m.T, Ns=m.Ns, S=m.S,
                           slab_max_depth=m.slab_max_depth, build_s=build_s)
    width, height = C.VR_EYE_RES
    rigs = [C.StereoRig(left=dataclasses.replace(cam, near=0.25), baseline=0.06)
            for cam in C.walk_trajectory(C.TrajectoryConfig(), args.frames, city.extent,
                                         focal_px=1400.0, width=width, height=height,
                                         device=dev)]
    base = P.SessionConfig(tau=48.0, w=4, w_star=32)
    focal = 1400.0
    sync_frames = list(range(0, args.frames, base.w))
    cuts = {}
    for f in sync_frames:
        cut, _ = LS.full_search(tree, rigs[f].left.pos, focal, base.tau)
        cuts[f] = cut.mask(tree)
    max_cut = max(int(c.sum()) for c in cuts.values())
    cut_budget = pow2_at_least(max_cut)
    rcfg0 = R.RenderConfig.for_rig(rigs[0], tile=base.tile, list_len=base.list_len)

    def queue_of(mask, budget):
        return P._render_queue(tree.gaussians, LS.compact_ids(mask, budget))

    def pair_total(queue, rig, rc):
        s, _ = R.project(queue, rig, rc)
        _x0, _y0, span_w, span_h = pair_spans(s.mean2d, s.ext, s.visible,
                                              rc.wide_width, rc.height, rc.tile)
        return int((span_w * span_h).sum())

    max_total = max(pair_total(queue_of(cuts[(i // base.w) * base.w], cut_budget), rig,
                               rcfg0) for i, rig in enumerate(rigs))
    max_pairs = pow2_at_least(max_total)
    cfg = dataclasses.replace(base, cut_budget=cut_budget, max_pairs=max_pairs)
    rcfg = R.RenderConfig.for_rig(rigs[0], tile=cfg.tile, list_len=cfg.list_len,
                                  max_pairs=cfg.max_pairs)
    log(f"[budgets] largest cut {max_cut} -> cut_budget {cut_budget}; largest pair "
        f"count {max_total} -> max_pairs {max_pairs}; n_cat {rcfg.n_cat}, wide grid "
        f"{rcfg.tiles_x_wide}x{rcfg.tiles_y} tiles, right {rcfg.tiles_x}x{rcfg.tiles_y}")
    if cut_budget < max_cut or max_pairs < max_total:
        raise AssertionError("budget sizing failed")
    report["budgets"] = dict(max_cut=max_cut, cut_budget=cut_budget,
                             max_pairs_needed=max_total, max_pairs=max_pairs,
                             n_cat=rcfg.n_cat)

    # 3. kernels against their plain versions, at the session's shapes --------
    kernels = {}
    cam0 = rigs[0].left.pos
    top_expand, _ = LS.top_sweep(tree, cam0, focal, cfg.tau)
    rpe = LS._root_parent_expand(tree, top_expand)
    sweep_args = (tree.slab_mu(), tree.slab_size(), tree.slab_parent, tree.slab_level,
                  tree.slab_is_leaf, tree.slab_valid, rpe, cam0, focal, cfg.tau)
    md = m.slab_max_depth
    k_out = lod_cut.lod_slab_sweep(*sweep_args, max_depth=md)
    p_out = lod_cut.slab_sweep_plain(*sweep_args, max_depth=md)
    torch.cuda.synchronize()
    if not (torch.equal(k_out[0], p_out[0]) and torch.equal(k_out[1], p_out[1])):
        raise AssertionError("K1: in_cut/root_expand differ from the plain version "
                             f"({int((k_out[0] != p_out[0]).sum())} nodes)")
    fin = torch.isfinite(p_out[2])
    if not torch.equal(fin, torch.isfinite(k_out[2])) or not torch.allclose(
            k_out[2][fin], p_out[2][fin], rtol=1e-6, atol=0.0):
        raise AssertionError("K1: rho differs from the plain version beyond 1e-6")
    n_nodes = m.Ns * m.S
    k1_bytes = n_nodes * (12 + 4 + 4 + 4 + 1 + 1) + m.Ns + 12 + n_nodes + m.Ns * 5
    kernels["lod_slab_sweep"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/lod_cut.cu",
        replaces="src/repro/kernels/lod_cut.py:127",
        max_abs_err=float((k_out[2][fin] - p_out[2][fin]).abs().max()) if fin.any() else 0.0,
        ms=cuda_ms(torch, lambda: lod_cut.lod_slab_sweep(*sweep_args, max_depth=md),
                   REPS),
        device_ms=device_ms(torch, lambda: lod_cut.lod_slab_sweep(*sweep_args, max_depth=md),
                            "lod_sweep_kernel"),
        plain_ms=cuda_ms(torch, lambda: lod_cut.slab_sweep_plain(*sweep_args, max_depth=md),
                         3),
        bytes=k1_bytes, ops=n_nodes * 22)

    q0 = queue_of(cuts[0], cut_budget)
    wide = rcfg.widened(rigs[0].left)

    def check_k3(queue, what):
        """K3 against its plain version on `queue`: every field within 2e-5
        (NaN where the plain version has NaN), `visible` exact. Returns the
        kernel's splats and the largest |error| over finite values."""
        k_s = preprocess.preprocess(queue, rigs[0], wide)
        p_s = preprocess.preprocess_plain(queue, rigs[0], wide)
        torch.cuda.synchronize()
        err = 0.0
        for name in ("mean2d", "depth", "conic", "ext", "color_l", "color_r", "opacity",
                     "disparity"):
            # splats behind the camera overflow to inf/nan on both sides
            a, b_ = getattr(k_s, name), getattr(p_s, name)
            if not torch.allclose(a, b_, rtol=2e-5, atol=2e-5, equal_nan=True):
                bad = ~torch.isclose(a, b_, rtol=2e-5, atol=2e-5, equal_nan=True)
                rows = bad.reshape(bad.shape[0], -1).any(1)
                log(f"[K3] {what} {name}: {int(rows.sum())} rows differ, "
                    f"{int((rows & p_s.visible).sum())} visible; depth of those "
                    f"{p_s.depth[rows][:8].tolist()}; kernel {a[rows][:4].tolist()} plain "
                    f"{b_[rows][:4].tolist()}")
                raise AssertionError(f"K3 ({what}): {name} differs from the plain version "
                                     "beyond 2e-5")
            both = torch.isfinite(a) & torch.isfinite(b_)
            if both.any():
                err = max(err, float((a[both] - b_[both]).abs().max()))
        if not torch.equal(k_s.visible, p_s.visible):
            raise AssertionError(f"K3 ({what}): visible differs on "
                                 f"{int((k_s.visible != p_s.visible).sum())}")
        return k_s, err

    sk, err3 = check_k3(q0, "queue")
    _, err3_tail = check_k3(q0[:q0.n - K3_TAIL], f"queue less {K3_TAIL} rows")
    log(f"[K3] == plain on the queue ({q0.n} rows) and on its first {q0.n - K3_TAIL} "
        f"(a tail block of {(q0.n - K3_TAIL) % 256} rows)")
    n_q, kk = q0.n, q0.sh.shape[1]
    k3_call = (lambda: preprocess.preprocess(q0, rigs[0], wide))
    kernels["preprocess"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/preprocess.cu",
        replaces="src/repro/kernels/preprocess.py:140", max_abs_err=max(err3, err3_tail),
        ms=cuda_ms(torch, k3_call, REPS),
        device_ms=device_ms(torch, k3_call, "preprocess_kernel"),
        plain_ms=cuda_ms(torch, lambda: preprocess.preprocess_plain(q0, rigs[0], wide), 3),
        # rows in, the camera's 25 floats, 16 floats and a visible byte out
        bytes=n_q * (3 + 3 + 4 + 1 + 3 * kk) * 4 + 25 * 4 + n_q * (16 * 4 + 1),
        ops=n_q * (278 + 18 * kk))

    ranks = depth_ranks(sk)
    left = R.bin_shared(sk, ranks, rcfg)
    src_r, src_i = build_merge_sources(left, sk, ranks, tile=rcfg.tile, width=rcfg.width,
                                       n_cat=rcfg.n_cat)
    mk = stereo_shift.stereo_merge_kernel(src_r, src_i)
    mp = stereo_shift.stereo_merge_plain(src_r, src_i)
    torch.cuda.synchronize()
    for name, a, b_ in zip(("ids", "count", "overflow"), mk, mp):
        if not torch.equal(a, b_):
            raise AssertionError(f"K4: {name} differs from the plain version")
    live = int((src_r < stereo_shift.INF_RANK).sum())
    written = int(mp[1].clamp_max(src_r.shape[-1]).sum())
    n_rt = src_r.shape[0]
    # beyond the session's shape: the VR rig at tile 8 needs n_cat = 44 (here the
    # session's rows and 21 of them again, with other ids: every rank tied across
    # rows), and ranks repeated inside a row (each entry twice), on K4_TILES tiles
    sub_r, sub_i = src_r[:K4_TILES], src_i[:K4_TILES]
    more = max(0, 44 - rcfg.n_cat)
    k4_cases = {
        "n_cat 44": (torch.cat([sub_r, sub_r[:, :more]], 1).contiguous(),
                     torch.cat([sub_i, sub_i[:, :more] + 1], 1).contiguous()),
        "repeats in a row": (sub_r.repeat_interleave(2, -1)[..., :sub_r.shape[-1]].contiguous(),
                             torch.arange(sub_r.numel(), device=dev, dtype=torch.int32)
                             .reshape(sub_r.shape))}
    k4_extra = {}
    for name, (cr, ci) in k4_cases.items():
        a4 = stereo_shift.stereo_merge_kernel(cr, ci)
        p4 = stereo_shift.stereo_merge_plain(cr, ci)
        torch.cuda.synchronize()
        for field, a, b_ in zip(("ids", "count", "overflow"), a4, p4):
            if not torch.equal(a, b_):
                raise AssertionError(f"K4 ({name}): {field} differs from the plain version")
        k4_extra[name] = dict(shape=list(cr.shape), count_sum=int(p4[1].sum()),
                              ms=cuda_ms(torch, lambda: stereo_shift.stereo_merge_kernel(cr, ci),
                                         REPS))
        log(f"[K4] {name} {list(cr.shape)}: == plain (ids, count, overflow); "
            f"{k4_extra[name]['ms']:.4f} ms")
    report["k4_cases"] = k4_extra
    del k4_cases, sub_r, sub_i, cr, ci, a4, p4
    kernels["stereo_merge"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/stereo_shift.cu",
        replaces="src/repro/kernels/stereo_shift.py:57", max_abs_err=0.0,
        ms=cuda_ms(torch, lambda: stereo_shift.stereo_merge_kernel(src_r, src_i), REPS),
        device_ms=device_ms(torch, lambda: stereo_shift.stereo_merge_kernel(src_r, src_i),
                            "stereo_merge_kernel"),
        plain_ms=cuda_ms(torch, lambda: stereo_shift.stereo_merge_plain(src_r, src_i), 3),
        # every live rank and one INF a row are read; an id only for the
        # entries written (the first L emits of a tile)
        bytes=live * 4 + written * 4 + n_rt * (rcfg.n_cat * 4 + rcfg.list_len * 4 + 4 + 1),
        ops=live * rcfg.n_cat)

    ent, counts = rasterize.gather_entries(left, sk, "left")
    origins = rasterize.tile_origins(ent.shape[0], left.tiles_x, rcfg.tile, dev)
    counts = counts.contiguous()
    # the session's left eye: the reference's default path (flags past a
    # stop); the right eye and the pooled render: the Pallas contract
    rk = rasterize.rasterize_slabs(ent, counts, origins, tile=rcfg.tile, hits_past_stop=True)
    rp = rasterize.rasterize_slabs_plain(ent, counts, origins, tile=rcfg.tile,
                                         hits_past_stop=True)
    pk = rasterize.rasterize_slabs(ent, counts, origins, tile=rcfg.tile)
    pp = rasterize.rasterize_slabs_plain(ent, counts, origins, tile=rcfg.tile,
                                         with_processed=True)
    torch.cuda.synchronize()
    for what, (k_img, k_hits), (p_img, p_hits) in (("default-path contract", rk, rp),
                                                   ("Pallas contract", pk, pp[:2])):
        if not torch.allclose(k_img, p_img, rtol=1e-5, atol=1e-6):
            raise AssertionError(f"K2 ({what}): tile image differs from the plain version "
                                 "beyond rtol 1e-5 / atol 1e-6")
        if not torch.equal(k_hits, p_hits):
            raise AssertionError(f"K2 ({what}): hits differ on "
                                 f"{int((k_hits != p_hits).sum())} entries")
    if bool((pp[1] & ~rp[1]).any()):
        raise AssertionError("K2: a Pallas-contract hit is missing under the default path")
    # the kernel blends a tile's entries until no pixel lets light through,
    # then (default path) only flags the rest: its work is the entries
    # blended plus the entries flagged, not the entries gathered
    n_t, l_len = ent.shape[0], ent.shape[1]
    n_gathered = int(counts.clamp(0, l_len).sum())
    n_ent = int(pp[2].sum())
    n_flag_only = n_gathered - n_ent
    slot = torch.arange(l_len, device=dev)[None, :]
    past = (slot >= pp[2][:, None]) & (slot < counts[:, None])
    flags_past_stop = int((rp[1] & past).sum())
    right0 = R.stereo_merge(sk, ranks, left, rcfg)
    skipped = {c: stereo.alpha_skip_stats(left, right0, h, sk).right_alpha_skipped
               for c, h in (("default_path", rp[1]), ("pallas", pp[1]))}
    log(f"[K2] == plain on the session's left tiles under both hit contracts; "
        f"{n_gathered} entries gathered, {n_ent} blended, {n_flag_only} flagged only "
        f"after a stop, {flags_past_stop} hit flags past the stop; frame 0's "
        f"right_alpha_skipped {skipped['default_path']} (default path) vs "
        f"{skipped['pallas']} (the Pallas contract)")
    px = rcfg.tile * rcfg.tile

    def k2_call():
        return rasterize.rasterize_slabs(ent, counts, origins, tile=rcfg.tile,
                                         hits_past_stop=True)

    def k2_pallas_call():
        return rasterize.rasterize_slabs(ent, counts, origins, tile=rcfg.tile)

    kernels["rasterize_slabs"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/rasterize.cu",
        replaces="src/repro/kernels/rasterize.py:77",
        max_abs_err=max(float((rk[0] - rp[0]).abs().max()), float((pk[0] - pp[0]).abs().max())),
        ms=cuda_ms(torch, k2_call, REPS), device_ms=device_ms(torch, k2_call, "rasterize_kernel"),
        plain_ms=cuda_ms(torch, lambda: rasterize.rasterize_slabs_plain(
            ent, counts, origins, tile=rcfg.tile, hits_past_stop=True), 3),
        # each gathered entry read once; a blended pixel-entry costs 25
        # operations; a flagged-only entry 11 (the α core and its test) at
        # one pixel where it hits, at every pixel where it does not
        bytes=n_gathered * 36 + n_t * (4 + 8 + px * 12 + l_len),
        ops=n_ent * px * 25 + flags_past_stop * 11 + (n_flag_only - flags_past_stop) * px * 11)
    k2_contracts = dict(
        default_path=dict(ms=kernels["rasterize_slabs"]["ms"],
                          device_ms=kernels["rasterize_slabs"]["device_ms"]),
        pallas=dict(ms=cuda_ms(torch, k2_pallas_call, REPS),
                    device_ms=device_ms(torch, k2_pallas_call, "rasterize_kernel"),
                    bound=bound(n_ent * 36 + n_t * (4 + 8 + px * 12 + l_len),
                                n_ent * px * 25)),
        gathered=n_gathered, blended=n_ent, flagged_only=n_flag_only,
        flags_past_stop=flags_past_stop, frame0_right_alpha_skipped=skipped)
    for c, v in k2_contracts.items():
        if isinstance(v, dict) and "ms" in v:
            log(f"[K2] left image, {c}: {v['ms']:.4f} ms (events), "
                f"{fmt_ms(v['device_ms'])} (device)")
    report["k2_contracts"] = k2_contracts
    del rk, rp, pk, pp, right0

    # K2 where tiles stop inside a window: the session's tiles at eps_t > 0,
    # then the adversarial tiles of tests/_raster_cases.py (stops around the
    # edges of windows of 8, 16 and 32 entries with an entry of α > 0 right
    # after, count 0, -1, L and L + 5, NaN/inf conics and opacities)
    def check_k2(e, c, o, what, **kw):
        img, hits, done = rasterize.rasterize_slabs_plain(e, c, o, with_processed=True, **kw)
        k_img, k_hits = rasterize.rasterize_slabs(e, c, o, **kw)
        torch.cuda.synchronize()
        if not torch.equal(k_hits, hits):
            raise AssertionError(f"K2 ({what}): hits differ on "
                                 f"{int((k_hits != hits).sum())} entries")
        if not torch.allclose(k_img, img, rtol=1e-5, atol=1e-6):
            raise AssertionError(f"K2 ({what}): image differs beyond rtol 1e-5 / atol 1e-6")
        return done

    for amin, amax in K2_THRESHOLDS:
        check_k2(ent, counts, origins, f"session tiles, α ({amin:.4g}, {amax})",
                 tile=rcfg.tile, alpha_min=amin, alpha_max=amax, hits_past_stop=True)
    log(f"[K2] == plain on the session's left tiles at α thresholds {K2_THRESHOLDS}")
    k2_stops = {}
    for eps in K2_STOP_EPS:
        done = check_k2(ent, counts, origins, f"session tiles, eps_t {eps}",
                        tile=rcfg.tile, eps_t=eps)
        stopped = done < counts.clamp(0, ent.shape[1])
        k2_stops[eps] = dict(blended=int(done.sum()), stopped=int(stopped.sum()),
                             inside=int((stopped & (done % K2_WINDOW != 0)).sum()))
        log(f"[K2] == plain on the session's tiles at eps_t {eps}: "
            f"{k2_stops[eps]['stopped']} of {n_t} tiles stop early, inside a window "
            f"{k2_stops[eps]['inside']}; {k2_stops[eps]['blended']} entries blended")
    sys.path.insert(0, str(ROOT / "tests"))
    from _raster_cases import raster_cases
    n_cases = 0
    for tile_c in (8, 16, 24, 32):
        for eps in (0.0, 0.02, 1.0):
            for l_len in (256, 45):
                arrays = raster_cases(tile_c * 7 + l_len, tile_c, eps, l_len)
                e, c, o = (torch.from_numpy(x).to(dev) for x in arrays[:3])
                done = check_k2(e, c, o, f"cases tile {tile_c} eps_t {eps} L {l_len}",
                                tile=tile_c, eps_t=eps)
                want = torch.from_numpy(arrays[3]).to(dev)
                if not torch.equal(done[want >= 0], want[want >= 0]):
                    raise AssertionError(f"K2 cases tile {tile_c} eps_t {eps} L {l_len}: "
                                         "the plain version misses a designed stop")
                n_cases += e.shape[0]
    log(f"[K2] == plain on {n_cases} adversarial tiles (tiles 8/16/24/32, "
        "eps_t 0/0.02/1, L 256/45)")
    report["k2_stops"] = dict(session=k2_stops, adversarial_tiles=n_cases)
    for name, k in kernels.items():
        k["bound_ms"], k["bound_by"] = bound(k["bytes"], k["ops"])
        log(f"[kernel] {name}: {k['ms']:.4f} ms (events), {fmt_ms(k.get('device_ms'))} "
            f"(device), plain {k['plain_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms "
            f"({k['bound_by']}), max |err| {k['max_abs_err']:.3g}")
    shapes = dict(slabs=[m.Ns, m.S], queue=n_q, left_tiles=n_t, right_tiles=n_rt,
                  live_merge_entries=live, merge_ids_written=written,
                  raster_entries_gathered=n_gathered,
                  raster_entries_blended=n_ent)
    log(f"[kernel] shapes {json.dumps(shapes)}")
    report["kernel_shapes"] = shapes
    del src_r, src_i, ent, mk, mp

    # 4. small-input reference: tiled stereo (kernels) vs untiled per pixel ----
    g_small = G.random_gaussians(np.random.default_rng(0), 600,
                                 sh_degree=1, extent=6.0, device=dev)
    rig_small = C.StereoRig(left=C.make_camera([0, -18, 2], [0, 0, 0], focal_px=220.0,
                                               width=128, height=96, near=0.2, device=dev),
                            baseline=0.06)
    il, ir, (_s, ll, rl, _st) = P.render_stereo(g_small, rig_small, tile=16, list_len=256)
    ref_l, ref_r = P.render_stereo_reference(g_small, rig_small)
    torch.cuda.synchronize()
    if bool(ll.overflow) or bool(rl.overflow):
        raise AssertionError("small reference scene overflowed its budgets")
    for a, b_, eye in ((il, ref_l, "left"), (ir, ref_r, "right")):
        if not torch.allclose(a, b_, rtol=1e-5, atol=1e-6):
            raise AssertionError(f"tiled {eye} eye differs from the untiled reference")
    bitwise = bool(torch.equal(il, ref_l) and torch.equal(ir, ref_r))
    log(f"[reference] 600 splats at 128x96: tiled stereo == untiled reference "
        f"(allclose; bitwise={bitwise})")
    report["reference_bitwise"] = bitwise

    # 5. the session -----------------------------------------------------------
    sess = P.CollaborativeSession(tree, cfg, rigs[0])
    torch.cuda.synchronize()
    K.reset_launch_counts()
    vq_assign.reset_filter_counts(dev)
    frames = []
    sync_cuts = {}
    bin_frame = []           # the latest frame's `bin_tiles` call: (args, kwargs)
    bin_kept = keep_calls(BN.bin_tiles, bin_frame, last=True)
    t_run = time.perf_counter()
    for i, rig in enumerate(rigs):
        t1 = time.perf_counter()
        with mock.patch.object(BN, "bin_tiles", bin_kept):
            st, out = sess.step(rig, render=True)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
        il, ir, (_s, ll, rl, sst) = out
        if tuple(il.shape) != (height, width, 3) or tuple(ir.shape) != (height, width, 3):
            raise AssertionError(f"frame {i}: image shape {tuple(il.shape)}")
        if not (torch.isfinite(il).all() and torch.isfinite(ir).all()):
            raise AssertionError(f"frame {i}: non-finite pixels")
        if float(il.max()) <= 0 or float(ir.max()) <= 0:
            raise AssertionError(f"frame {i}: blank image")
        if st.synced:
            sync_cuts[i] = (sess.state.cut_gids.clone(), st.cut_size)
        row = dict(dataclasses.asdict(st), ms=ms, left_overflow=bool(ll.overflow),
                   right_overflow=bool(rl.overflow), stereo=dataclasses.asdict(sst))
        frames.append(row)
        log(f"[frame {i:2d}] synced={st.synced} cut={st.cut_size} delta={st.delta_size} "
            f"bytes={st.sync_bytes:.0f} touched={st.nodes_touched} resweeps={st.resweeps} "
            f"resident={st.client_resident} overflow(L,R)=({row['left_overflow']},"
            f"{row['right_overflow']}) right_candidates={sst.right_candidates} "
            f"alpha_skipped={sst.right_alpha_skipped} {ms:.1f} ms")
    run_s = time.perf_counter() - t_run
    counts_session = K.launch_counts()
    log(f"[session] kernels {json.dumps(counts_session)}")
    require_launched("session", counts_session, ("lod_slab_sweep", "preprocess",
                                                 "stereo_merge", "rasterize_slabs",
                                                 "vq_assign", "bin_tiles"))
    if counts_session["bin_tiles"] != args.frames:
        raise AssertionError(f"the session launched the binning chain "
                             f"{counts_session['bin_tiles']} times in {args.frames} frames")
    k5_session = require_filtered("session", vq_assign.filter_counts(dev))
    log(f"[session] {args.frames} frames in {run_s:.2f} s; compressed wire "
        f"{sess.bytes_per_g:.0f} B a Gaussian (raw rows would be "
        f"{4 * (3 + 3 + 4 + 1 + 3 * tree.gaussians.sh.shape[1])} B)")
    report["frames"] = frames

    # every sync's cut equals a full search at the same camera
    for i, (gids, count) in sync_cuts.items():
        full, _ = LS.full_search(tree, rigs[i].left.pos, focal, cfg.tau)
        want, n_want, _ = LS.cut_gids(full, tree, cfg.cut_budget)
        if not torch.equal(gids, want) or int(n_want) != count:
            raise AssertionError(f"frame {i}: temporal cut differs from a full search")
    log(f"[session] the {len(sync_cuts)} temporal cuts equal full searches")

    # the binning chain against its plain version on the last frame's inputs
    (b_args, b_kw), = bin_frame
    b_lists = bin_chain_check(torch, BN, kbin, (b_args, b_kw), f"session frame {args.frames - 1}")
    tracing.enable()
    BN.bin_tiles(*b_args, **b_kw)
    tracing.disable()
    b_counted = tracing.drain()["counters"]
    b_need, b_kept = b_counted["bin.pairs_needed"], b_counted["bin.pairs_sorted"]
    b_m, b_tiles, b_len = b_args[0].shape[0], b_lists.lists.shape[0], b_args[6].list_len
    b_key = 4 if kbin.wide_key(b_tiles) else 2

    def bin_call():
        return BN.bin_tiles(*b_args, **b_kw)

    b_prof = profiled(torch, "the binning chain, one call at the session's last frame",
                      bin_call)
    b_sort = sum(t for name, t in b_prof["by_name"].items()
                 if "DeviceRadixSort" in name and "at_cuda_detail" not in name)
    b_fill = sum(t for name, t in b_prof["by_name"].items() if "bin_fill_kernel" in name)
    kernels["bin_tiles"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/binning.cu",
        replaces="none (src/repro/core/binning.py:68 bins with jnp sorts)", max_abs_err=0.0,
        ms=cuda_ms(torch, bin_call, REPS),
        device_ms=device_ms(torch, bin_call, "", n=5, per_call=None),
        plain_ms=cuda_ms(torch, lambda: BN.bin_tiles_plain(*b_args, **b_kw), 3),
        # each splat's mean, extent, rank, visibility and cull radius² read
        # once; each kept pair written once by the emit and read once by the
        # fill (its tile key and splat id); the lists and counts written once
        bytes=b_m * (8 + 8 + 4 + 1 + 4) + b_kept * (b_key + 4) * 2 + b_tiles * (b_len + 1) * 4,
        # the precise cull: 14 float operations a pair before it
        ops=b_need * 14)
    kb = kernels["bin_tiles"]
    kb["bound_ms"], kb["bound_by"] = bound(kb["bytes"], kb["ops"])
    report["bin_tiles"] = dict(
        splats=b_m, tiles=b_tiles, list_len=b_len, max_pairs=b_args[6].max_pairs,
        pairs_needed=b_need, pairs_kept=b_kept, key_bytes=b_key,
        list_entries=int(b_lists.counts.sum()), overflow=bool(b_lists.overflow),
        profile_busy_ms=b_prof["device_busy_ms"], sort_device_ms=b_sort,
        fill_device_ms=b_fill)
    log(f"[bin] chain == plain at the session's last frame: {b_m} splats, {b_tiles} tiles, "
        f"{b_need} pairs needed, {b_kept} kept (budget {b_args[6].max_pairs}); "
        f"{kb['ms']:.4f} ms (events), {fmt_ms(kb['device_ms'])} (device; CUB's sort "
        f"{b_sort:.4f}, the fill {b_fill:.4f} of one profiled call), plain "
        f"{kb['plain_ms']:.4f} ms, bound {kb['bound_ms']:.4f} ms ({kb['bound_by']}: "
        f"{kb['bytes']} B)")
    del b_lists, bin_frame, bin_kept, b_args, b_kw

    # per-stage times of one more sync frame and its render: the session's
    # own calls, each stage function wrapped with a synchronize on both sides
    stage_timer = StageTimer(torch)
    rig = rigs[-1]
    state = dataclasses.replace(sess.state, frame_index=0)
    with contextlib.ExitStack() as patches:
        for mod, name in ((P, "session_step"), (P, "_render_queue"), (RS, "project"),
                          (RS, "bin_shared"), (RS, "stereo_merge"),
                          (RS, "rasterize"), (P, "alpha_skip_stats")):
            patches.enter_context(mock.patch.object(
                mod, name, stage_timer.wrap(name, getattr(mod, name))))
        state, _ = P.session_step(sess.tree, sess.codec, cfg, state, rig.left.pos, focal,
                                  sess.bytes_per_g)
        stage_timer.wrap("client_render_step", P.client_render_step)(cfg, state, rig)
    stages = stage_timer.ms
    log(f"[stages] {json.dumps({k: round(v, 3) for k, v in stages.items()})}")
    report["stages_ms"] = stages

    # 6. device time of one sync + one rendered frame (torch.profiler) ------
    state = dataclasses.replace(state, frame_index=0)

    def sync_and_render():
        nonlocal state
        state, _ = P.session_step(sess.tree, sess.codec, cfg, state, rig.left.pos, focal,
                                  sess.bytes_per_g)
        P.client_render_step(cfg, state, rig)

    report["profile"] = profiled(torch, "sync + render frame", sync_and_render)

    del sess, state
    torch.cuda.empty_cache()

    # 7. the fleet ----------------------------------------------------------------
    b_cl = args.clients
    sync_frames = [i * base.w for i in range(args.syncs)]
    walks = [list(C.walk_trajectory(C.TrajectoryConfig(seed=c), sync_frames[-1] + base.w + 1,
                                    city.extent, focal_px=focal, width=width,
                                    height=height, device=dev)) for c in range(b_cl)]
    cams = np.stack([[walks[c][f].pos.cpu().numpy() for c in range(b_cl)]
                     for f in sync_frames + [sync_frames[-1] + base.w]]
                    ).astype(np.float32)     # (syncs + 1, B, 3); the last is profiled
    taus = np.where(np.arange(b_cl) % 2 == 0, 48.0, 84.0).astype(np.float32)
    fleet_max_cut = max(int(LS.full_search(tree, cams[f, c], focal, float(taus[c]))[0]
                            .count()) for f in range(len(cams)) for c in range(b_cl))
    fcfg = P.SessionConfig(tau=48.0, w=base.w, w_star=32,
                           cut_budget=pow2_at_least(fleet_max_cut))
    log(f"[fleet] {b_cl} clients, taus {taus.tolist()}, largest cut {fleet_max_cut} -> "
        f"cut_budget {fcfg.cut_budget}; {args.syncs} syncs every {base.w} frames")
    service = SV.LodService(tree, fcfg, b_cl, focal=focal, mode="pooled", taus=taus)
    log(f"[fleet] delta_budget {service.delta_budget}, page_size {service.page_size}, "
        f"{service.bytes_per_g:.0f} B a Gaussian")
    fleet_rigs = [C.StereoRig(left=dataclasses.replace(walks[c][sync_frames[-1]],
                                                       near=0.25), baseline=0.06)
                  for c in range(b_cl)]
    timer = StageTimer(torch)
    captured = {}

    def recording(name, fn, keep):
        def run(*a, **kw):
            if keep(len(sync_rows)) and name not in captured:
                captured[name] = (a, kw)
            return fn(*a, **kw)
        return run

    sync_rows = []
    torch.cuda.synchronize()
    K.reset_launch_counts()
    vq_assign.reset_filter_counts(dev)
    t_fleet = time.perf_counter()
    with contextlib.ExitStack() as patches:
        for mod, name, label in ((LS, "batched_top_and_staleness", "top_and_staleness"),
                                 (SV, "_compact_stale_pairs", "compaction"),
                                 (SV, "_pooled_pair_sweep", "k6_sweep"),
                                 (SV, "_apply_pooled_updates", "scatter"),
                                 (MG, "batched_cloud_sync", "tables"),
                                 (DP, "build_delta_batch", "union_and_encode")):
            patches.enter_context(mock.patch.object(
                mod, name, timer.wrap(label, getattr(mod, name))))
        patches.enter_context(mock.patch.object(
            SV, "lod_pair_sweep", recording("k6_warm", SV.lod_pair_sweep, lambda i: i > 0)))
        patches.enter_context(mock.patch.object(
            CP, "vq_assign", recording("k5_cold", CP.vq_assign, lambda i: i == 0)))
        for f in range(args.syncs):
            timer.ms = {}
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            st = service.sync(cams[f])
            torch.cuda.synchronize()
            sync_ms = (time.perf_counter() - t1) * 1e3
            t2 = time.perf_counter()
            for c in range(b_cl):
                ids, dec = service.client_delta(c)
            torch.cuda.synchronize()
            decode_ms = (time.perf_counter() - t2) * 1e3
            n_stale = int(st.resweeps.sum())
            batch = service.last_delta
            row = dict(sync=f, ms=sync_ms, stale_pairs=n_stale, pairs=b_cl * m.Ns,
                       bucket=LS.pow2_bucket(n_stale, b_cl * m.Ns) if n_stale else 0,
                       union=int(batch.n_union), shipped=int(batch.n_shipped),
                       width=int(batch.union_gids.shape[0]),
                       bytes=st.sync_bytes.tolist(), cut=st.cut_size.tolist(),
                       delta=st.delta_size.tolist(), unique=int(st.unique_delta.sum()),
                       overflow=bool(st.overflow.any()),
                       stages_ms=dict(timer.ms, decode_all_clients=decode_ms))
            sync_rows.append(row)
            log(f"[fleet sync {f}] {sync_ms:.2f} ms; stale pairs {n_stale}/{b_cl * m.Ns} "
                f"-> bucket {row['bucket']}; Δ-union {row['union']} (unique "
                f"{row['unique']} of {sum(row['delta'])} requested), shipped "
                f"{row['shipped']} in width {row['width']}; bytes/client "
                f"{[round(x) for x in row['bytes']]}; cut/client {row['cut']}")
            log(f"[fleet sync {f}] stages ms {json.dumps({k: round(v, 3) for k, v in row['stages_ms'].items()})}")
        if any(r["overflow"] for r in sync_rows):
            raise AssertionError("a fleet cut overflowed its cut budget")
        # sizing the render's pair budget projects every queue: not the path
        counts_syncs = K.launch_counts()
        k5_fleet = require_filtered("fleet", vq_assign.filter_counts(dev))
        queues = [SV._masked_queue(service.tree.gaussians, g) for g in service.state.cut_gids]
        rcfg_f = R.RenderConfig.for_fleet(fleet_rigs, tile=base.tile, list_len=base.list_len)
        fleet_pairs = pow2_at_least(max(pair_total(q, r, rcfg_f)
                                        for q, r in zip(queues, fleet_rigs)))
        del queues
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t3 = time.perf_counter()
        gather = RB._gather_fleet_slabs

        def gather_and_keep(*a, **kw):
            captured["k2_slabs"] = gather(*a, **kw)
            return captured["k2_slabs"]

        # the pooled launch's inputs: the fleet's slabs and the bucket `sel`
        # that picks the occupied ones (the kernel module itself is not
        # patched: its wrapper counts launches under its own name)
        bin_pooled = []      # each client's `bin_tiles` call of the pooled render
        with mock.patch.object(RB, "_gather_fleet_slabs", gather_and_keep), \
                mock.patch.object(RB, "_scatter_slabs", recording(
                    "k2_sel", RB._scatter_slabs, lambda i: True)), \
                mock.patch.object(BN, "bin_tiles", keep_calls(BN.bin_tiles, bin_pooled)):
            fl, fr, fst = service.render_fallback(fleet_rigs, list_len=base.list_len,
                                                  max_pairs=fleet_pairs, path="pooled")
        torch.cuda.synchronize()
        render_ms = (time.perf_counter() - t3) * 1e3
    counts_fleet = {k: v + counts_syncs[k] for k, v in K.launch_counts().items()}
    fleet_s = time.perf_counter() - t_fleet
    log(f"[fleet] kernels {json.dumps(counts_fleet)}")
    require_launched("fleet", counts_fleet, ("lod_pair_sweep", "vq_assign",
                                             "rasterize_slabs", "bin_tiles"))
    if counts_fleet["rasterize_slabs"] != 1:
        raise AssertionError(f"the pooled fallback render launched K2 "
                             f"{counts_fleet['rasterize_slabs']} times, not once")
    if tuple(fl.shape) != (b_cl, height, width, 3) or not (
            torch.isfinite(fl).all() and torch.isfinite(fr).all()):
        raise AssertionError(f"fallback frames: shape {tuple(fl.shape)} or non-finite")
    if bool((fl.flatten(1).amax(1) <= 0).any()):
        raise AssertionError("a fallback frame is blank")
    log(f"[fleet] pooled fallback render of {b_cl} clients at {width}x{height} per eye "
        f"(max_pairs {fleet_pairs}): {render_ms:.1f} ms; left blends/client "
        f"{fst.left_blends.tolist()}; {args.syncs} syncs + render in {fleet_s:.2f} s")
    report["fleet"] = dict(clients=b_cl, taus=taus.tolist(), cut_budget=fcfg.cut_budget,
                           delta_budget=service.delta_budget, syncs=sync_rows,
                           render_ms=render_ms, max_pairs=fleet_pairs)

    # 8. fleet cross-checks on the card ------------------------------------------
    vl, vr, vst = service.render_fallback(fleet_rigs, list_len=base.list_len,
                                          max_pairs=fleet_pairs, path="vmap")
    torch.cuda.synchronize()
    if not (torch.equal(fl, vl) and torch.equal(fr, vr)):
        raise AssertionError("pooled fallback render differs from the per-client render")
    # the pooled launch keeps the Pallas contract (no flag past a stop), the
    # per-client render the default path's: every stat but the skipped
    # count is equal, and the pooled one skips at least as many (its hits
    # are held exactly against the plain version below)
    for fld in dataclasses.fields(fst):
        a, b_ = getattr(fst, fld.name), getattr(vst, fld.name)
        if fld.name == "right_alpha_skipped":
            if bool((a < b_).any()):
                raise AssertionError("pooled fallback skips fewer right entries than the "
                                     "per-client render")
        elif not torch.equal(a, b_):
            raise AssertionError(f"fallback frame stats differ: {fld.name}")
    log(f"[check] pooled fallback render == per-client render, bit for bit; "
        f"right_alpha_skipped per client {fst.right_alpha_skipped.tolist()} (pooled, "
        f"Pallas contract) vs {vst.right_alpha_skipped.tolist()} (per client, default path)")
    report["fleet"]["right_alpha_skipped"] = dict(pooled=fst.right_alpha_skipped.tolist(),
                                                  per_client=vst.right_alpha_skipped.tolist())
    del fl, fr, vl, vr
    # the pooled K2 launch at its fleet shape: time, and a bound over the
    # entries its tiles blend before they stop
    sel = captured.pop("k2_sel")[0][0]
    e2, c2, o2 = (x[sel] for x in captured.pop("k2_slabs"))
    kw2 = dict(tile=rcfg_f.tile, eps_t=rcfg_f.eps_t, alpha_min=rcfg_f.alpha_min,
               alpha_max=rcfg_f.alpha_max)
    img2, hits2, done2 = rasterize.rasterize_slabs_plain(e2, c2, o2, with_processed=True, **kw2)
    n2 = int(done2.sum())
    px = kw2["tile"] ** 2
    k2_bound = bound(n2 * 36 + e2.shape[0] * (4 + 8 + px * 12 + e2.shape[1]), n2 * px * 25)

    def k2_pooled_call():
        return rasterize.rasterize_slabs(e2, c2, o2, **kw2)

    # the pooled launch's hits (the Pallas contract) at the fleet's shape,
    # exactly: the per-client render above takes the default path's
    k_img2, k_hits2 = k2_pooled_call()
    torch.cuda.synchronize()
    if not torch.equal(k_hits2, hits2):
        raise AssertionError(f"pooled K2: hits differ from the plain version on "
                             f"{int((k_hits2 != hits2).sum())} entries")
    if not torch.allclose(k_img2, img2, rtol=1e-5, atol=1e-6):
        raise AssertionError("pooled K2: tile image differs from the plain version beyond "
                             "rtol 1e-5 / atol 1e-6")
    log(f"[check] pooled K2 == plain on the fleet's {e2.shape[0]} tiles ({int(hits2.sum())} "
        "hits, Pallas contract)")
    del k_img2, k_hits2, img2, hits2, done2

    k2_pooled = dict(ms=cuda_ms(torch, k2_pooled_call, REPS),
                     device_ms=device_ms(torch, k2_pooled_call, "rasterize_kernel", n=3))
    log(f"[kernel] rasterize_slabs pooled: {k2_pooled['ms']:.4f} ms (events), "
        f"{fmt_ms(k2_pooled['device_ms'])} (device) for {e2.shape[0]} tiles ({n2} entries "
        f"blended), bound {k2_bound[0]:.4f} ms ({k2_bound[1]})")
    # the wrapper's two outputs alone (the tile images are 12 B a pixel):
    # what the events around one pooled call see besides the kernel
    alloc_ms = cuda_ms(torch, lambda: (
        torch.empty((e2.shape[0], kw2["tile"], kw2["tile"], 3), device=dev),
        torch.empty(e2.shape[:2], dtype=torch.bool, device=dev)), REPS)
    log(f"[kernel] rasterize_slabs pooled: its two outputs alone take {alloc_ms:.4f} ms "
        "(events)")
    report["fleet"]["k2_pooled"] = dict(alloc_ms=alloc_ms, tiles=e2.shape[0], blended=n2,
                                        bound_ms=k2_bound[0], bound_by=k2_bound[1],
                                        **k2_pooled)
    del e2, c2, o2

    # the binning chain on each client's inputs to the pooled render
    if len(bin_pooled) != counts_fleet["bin_tiles"]:
        raise AssertionError(f"the pooled render binned {len(bin_pooled)} times, the chain "
                             f"launched {counts_fleet['bin_tiles']}")
    for c, call in enumerate(bin_pooled):
        lists_c = bin_chain_check(torch, BN, kbin, call, f"pooled render, call {c}")
    log(f"[check] binning chain == plain on the pooled render's {len(bin_pooled)} calls "
        f"(max_pairs {fleet_pairs}; the last: {int(lists_c.counts.sum())} list entries, "
        f"overflow {bool(lists_c.overflow)})")
    report["fleet"]["bin_tiles_checked"] = len(bin_pooled)
    del bin_pooled, lists_c, call

    (x5, cb5), _ = captured["k5_cold"]
    vq_assign.reset_filter_counts(dev)
    k5 = vq_assign.vq_assign(x5, cb5)
    k5_counts = vq_assign.filter_counts(dev)
    p5 = vq_assign.vq_assign_plain(x5, cb5)
    torch.cuda.synchronize()
    if not torch.equal(k5, p5):
        raise AssertionError(f"K5: codes differ from the plain version on "
                             f"{int((k5 != p5).sum())} of {x5.shape[0]} rows")
    m5, d5 = x5.shape
    kc5 = cb5.shape[0]
    if k5_counts["scanned"] != 0 or k5_counts["filtered"] != m5:
        raise AssertionError(f"K5: the cold Δ-union's rows did not all take the filter: "
                             f"{k5_counts}")
    cand_mean = k5_counts["candidates"] / m5
    log(f"[check] K5 == plain on the cold sync's Δ-union rows ({m5} x {d5}, {kc5} codes); "
        f"filtered {k5_counts['filtered']}, full-scan rows {k5_counts['scanned']}, "
        f"second pass {k5_counts['second_pass']}; candidates a row: mean {cand_mean:.4f}, "
        f"max {k5_counts['most_candidates']}")
    # tests/_vq_cases.py at every D: equal codewords, 1-ulp neighbours, dyadic
    # midpoints, 1e18 and overflow, subnormals, NaN/inf rows and codewords
    from _vq_cases import DIMS, vq_cases
    n_vq = 0
    for d_c in DIMS:
        for c in vq_cases(d_c):
            xc, cc = torch.from_numpy(c.x).to(dev), torch.from_numpy(c.codebook).to(dev)
            vq_assign.reset_filter_counts(dev)
            kc_ = vq_assign.vq_assign(xc, cc)
            got = vq_assign.filter_counts(dev)
            if not torch.equal(kc_, vq_assign.vq_assign_plain(xc, cc)):
                raise AssertionError(f"K5 case {c.name!r} at D {d_c}: codes differ")
            if got["scanned"] != c.scanned_rows():
                raise AssertionError(f"K5 case {c.name!r} at D {d_c}: {got['scanned']} rows "
                                     f"scanned, want {c.scanned_rows()}")
            n_vq += 1
    log(f"[check] K5 == plain on {n_vq} cases of tests/_vq_cases.py at D {DIMS}")
    k5_call = (lambda: vq_assign.vq_assign(x5, cb5))
    kernels["vq_assign"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/vq_assign.cu",
        replaces="src/repro/kernels/vq_assign.py:41", max_abs_err=0.0,
        ms=cuda_ms(torch, k5_call, REPS),
        device_ms=device_ms(torch, k5_call, "vq_filter_kernel"),
        plain_ms=cuda_ms(torch, lambda: vq_assign.vq_assign_plain(x5, cb5), 3),
        library_ms=cuda_ms(torch, lambda: torch.cdist(x5, cb5).argmin(1), REPS),
        bytes=m5 * d5 * 4 + kc5 * d5 * 4 + m5 * 4,
        # one TF32 product, one float32 max a score, the exact rescoring of
        # this run's candidates (2D + 2 each) and the codebook's norms
        ops=m5 * kc5 + k5_counts["candidates"] * (2 * d5 + 2) + kc5 * 2 * d5,
        tf32_ops=2 * m5 * kc5 * d5,
        # the bound of the same inputs with every score in float32
        fp32_bound_ms=bound(m5 * d5 * 4 + kc5 * d5 * 4 + m5 * 4,
                            m5 * kc5 * (2 * d5 + 2) + kc5 * 2 * d5)[0])
    report["k5"] = dict(cold_union=dict(k5_counts, mean_candidates=cand_mean),
                        session=k5_session, fleet=k5_fleet, cases=n_vq,
                        fp32_bound_ms=kernels["vq_assign"]["fp32_bound_ms"])
    log(f"[check] K5's bound with every score in float32: "
        f"{kernels['vq_assign']['fp32_bound_ms']:.4f} ms")

    if "k6_warm" not in captured:
        raise AssertionError("no warm fleet sync had a stale pair to sweep")
    a6, kw6 = captured["k6_warm"]
    k6 = lod_cut.lod_pair_sweep(*a6, **kw6)
    p6 = lod_cut.pair_sweep_plain(*a6, **kw6)
    torch.cuda.synchronize()
    for name, a, b_ in zip(("in_cut", "root_expand", "rho"), k6, p6):
        if not torch.equal(a, b_):
            raise AssertionError(f"K6: {name} differs from the plain version")
    n6, s6 = a6[1].shape
    kernels["lod_pair_sweep"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/lod_cut.cu",
        replaces="src/repro/kernels/lod_cut.py:81", max_abs_err=0.0,
        ms=cuda_ms(torch, lambda: lod_cut.lod_pair_sweep(*a6, **kw6), REPS),
        device_ms=device_ms(torch, lambda: lod_cut.lod_pair_sweep(*a6, **kw6),
                            "lod_sweep_kernel"),
        plain_ms=cuda_ms(torch, lambda: lod_cut.pair_sweep_plain(*a6, **kw6), 3),
        bytes=n6 * s6 * (12 + 4 + 4 + 4 + 1 + 1) + n6 * (1 + 12 + 4) + n6 * s6 + n6 * 5,
        ops=n6 * s6 * 22)
    log(f"[check] K6 == plain on the first warm sync's bucket ({n6} pairs x {s6})")
    del captured, k5, p5, x5, k6, p6, a6

    pooled = SV.LodService(tree, fcfg, b_cl, focal=focal, mode="pooled", taus=taus)
    vmapped = SV.LodService(tree, fcfg, b_cl, focal=focal, mode="vmapped", taus=taus)
    pooled.codec = vmapped.codec = service.codec
    for f in range(2):
        a, b_ = pooled.sync(cams[f]), vmapped.sync(cams[f])
        for fld in dataclasses.fields(a):
            if not torch.equal(getattr(a, fld.name), getattr(b_, fld.name)):
                raise AssertionError(f"fleet sync {f}: pooled and vmapped {fld.name} differ")
        if not torch.equal(pooled.state.cut_gids, vmapped.state.cut_gids):
            raise AssertionError(f"fleet sync {f}: pooled and vmapped cuts differ")
    log("[check] two pooled fleet syncs == two vmapped ones (cut ids, every ServiceStats "
        "field)")
    del pooled, vmapped
    report["fleet"]["profile"] = profiled(torch, "one more warm fleet sync",
                                          lambda: service.sync(cams[-1]))
    del service

    for name in ("vq_assign", "lod_pair_sweep"):
        k = kernels[name]
        k["bound_ms"], k["bound_by"] = bound(k["bytes"], k["ops"], k.get("tf32_ops", 0.0))
        log(f"[kernel] {name}: {k['ms']:.4f} ms (events), {fmt_ms(k.get('device_ms'))} "
            f"(device), plain {k['plain_ms']:.4f} ms, bound "
            f"{k['bound_ms']:.4f} ms ({k['bound_by']}), library "
            f"{k.get('library_ms') or float('nan'):.4f} ms, max |err| {k['max_abs_err']:.3g}")
    shapes.update(k5_rows=m5, k5_dim=d5, k5_codes=kc5, k6_pairs=n6, k6_slab=s6)
    log(f"[kernel] shapes {json.dumps(shapes)}")

    # 11. the ragged fleet, on phase 7's scene, before the LM phases free it -------
    t_rag = time.perf_counter()
    ragged = ragged_fleet(torch, dev, tree, city.extent, base, focal, width, height,
                          pair_total, card)
    counts_ragged = ragged.pop("counts")
    report["ragged"] = ragged
    report["phases"]["ragged_s"] = time.perf_counter() - t_rag
    log(f"[ragged] phase 11 took {report['phases']['ragged_s']:.1f} s")

    # 12. recovery, on phase 7's scene, before the LM phases free it ---------------
    t_rec = time.perf_counter()
    recovered = fleet_recovery(torch, dev, tree, city.extent, base, focal, width, height,
                               pair_total, ragged["cut_budget"], card)
    counts_recovery = recovered.pop("counts")
    report["recovery"] = recovered
    report["phases"]["recovery_s"] = time.perf_counter() - t_rec
    log(f"[recovery] phase 12 took {report['phases']['recovery_s']:.1f} s")

    # 13. the serving mesh, on phase 7's scene, before the LM phases free it -------
    t_mesh = time.perf_counter()
    meshed = fleet_mesh(torch, dev, tree, city.extent, base, focal, width, height,
                        pair_total, ragged["cut_budget"], card)
    counts_mesh = meshed.pop("counts")
    report["mesh"] = meshed
    report["phases"]["mesh_s"] = time.perf_counter() - t_mesh
    log(f"[mesh] phase 13 took {report['phases']['mesh_s']:.1f} s")

    # free the city before the LM phases
    del tree, leaves, cuts, sync_cuts, rigs, walks, fleet_rigs, q0, sk, left, ranks
    del origins, counts, k_out, p_out, sweep_args, rpe, top_expand, il, ir, ll, rl
    del ref_l, ref_r, g_small
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[lm] {torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated from "
        f"phases 1-8")

    # 9. the LM serving path -------------------------------------------------------
    t_lm = time.perf_counter()
    lm = lm_serving(torch, dev)
    counts_lm = lm.pop("counts")
    report["lm"] = lm
    t_k7 = time.perf_counter()

    # 10. K7 against its plain version at the LM shapes ----------------------------
    k7 = k7_cases(torch, dev)
    report["k7_cases"] = k7
    k7b = k7_backward_cases(torch, dev)
    fill_k7_device_ms(k7, k7b)
    report["k7_backward_cases"] = k7b
    report["phases"]["lm_s"] = t_k7 - t_lm
    report["phases"]["k7_cases_s"] = time.perf_counter() - t_k7
    log(f"[lm] phase 9 took {t_k7 - t_lm:.1f} s, phase 10 "
        f"{report['phases']['k7_cases_s']:.1f} s")

    # 14. every other LM family ---------------------------------------------------
    t_fam = time.perf_counter()
    families = lm_families(torch, dev, card)
    counts_families = families.pop("counts")
    report["families"] = families
    report["phases"]["families_s"] = time.perf_counter() - t_fam
    log(f"[families] phase 14 took {report['phases']['families_s']:.1f} s")

    # 15. training ---------------------------------------------------------------
    t_train = time.perf_counter()
    trained = lm_train(torch, dev, card)
    counts_train = trained.pop("counts")
    report["train"] = trained
    report["phases"]["train_s"] = time.perf_counter() - t_train
    log(f"[train] phase 15 took {report['phases']['train_s']:.1f} s")

    # 16. the sharding context and the dry-run ---------------------------------
    t_lmm = time.perf_counter()
    lmm = lm_mesh(torch, dev, card, trained)
    counts_lm_mesh = lmm.pop("counts")
    report["lm_mesh"] = lmm
    report["phases"]["lm_mesh_s"] = time.perf_counter() - t_lmm
    log(f"[lm_mesh] phase 16 took {report['phases']['lm_mesh_s']:.1f} s")

    main_case = k7[0]            # phase 9's prefill shape, by construction
    keys = ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels["flash_attention"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:59",
        **{key: main_case[key] for key in keys})
    # the backward at phase 15 (a)'s training shape in bf16, by construction; it
    # replaces no TPU kernel (XLA derives the reference's gradient): the line
    # names the forward it differentiates
    kernels["flash_attention_backward"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        replaces="src/repro/kernels/flash_attention.py:59",
        **{key: k7b[0][key] for key in keys})
    for name, k in kernels.items():
        log(f"[kernel] {name}: {k['ms']:.4f} ms by events, {fmt_ms(k.get('device_ms'))} of "
            f"device time (profiler), bound {k['bound_ms']:.4f} ms")

    rows = []
    for name, k in kernels.items():
        by_path = {"session": counts_session[name], "fleet": counts_fleet[name],
                   "ragged": counts_ragged[name], "recovery": counts_recovery[name],
                   "mesh": counts_mesh[name], "lm": counts_lm[name],
                   "families": counts_families[name], "train": counts_train[name],
                   "lm_mesh": counts_lm_mesh[name]}
        rows.append(dict(name=name, route=k["route"], source=k["source"],
                         replaces=k["replaces"], launches=sum(by_path.values()),
                         launches_by_path=by_path,
                         max_abs_err=k["max_abs_err"], ms=k["ms"], plain_ms=k["plain_ms"],
                         bound_ms=k["bound_ms"], bound_by=k["bound_by"],
                         library_ms=k.get("library_ms")))
    report["kernels"] = rows
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
