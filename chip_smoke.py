#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card, end to end.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. device  - the card's name and power limit; build every CUDA kernel from
             the sources in this checkout (one nvcc per source, in parallel);
2. kernels - each paged attention kernel at llama3_8b attention geometry
             against its plain PyTorch version (fp32 outputs; bf16 inputs at
             atol 1e-4 / rtol 1e-3, where only the summation order differs,
             and fp32 inputs at atol 1e-5 / rtol 1e-5), and its time beside
             the plain version's, a library yardstick's and its bound, and
             decode again at the serving burst's lengths; the readings of
             planted chunk faults (the walk one page short, the causal edge
             one position late) and decode faults (the last split dropped,
             the last position dropped), which those limits must fail; the
             chunk and decode kernels at other page sizes (12, 32, 64), head
             dims (32, 64, 96) and GQA ratios (1, 2, 8), and at llama3_1b's
             D 128 / n_rep 2; the chunk kernel at speculative verify's shape
             (16 slots from the burst's lengths, C = 5 rows with 1..5 valid,
             and C = 3 and 1) at llama3_8b and llama3_1b heads, on the rows
             verify reads, with its times at C = 5 (llama3_8b) beside the
             plain version's, SDPA's and the bound. Decode runs the split-KV kernel (CUDA
             cores) at every type and D; the bf16 chunk kernel at D 32/64/128 runs on
             tensor cores (mma.sync, P split into bf16 terms), fp32 and other
             head dims on CUDA cores. The log names each instantiation;
3. flash   - the flash forward, dq and dk/dv kernels against their plain
             versions at llama3_1b and llama3_8b attention geometry (B 2,
             T = S = 8192, bf16, causal), plus fp32 inputs, a ragged last
             tile (T = 72), causal=False, D 96 (the CUDA-core kernels at
             bf16) and a do of bf16 values (what training feeds dq and
             dk/dv), all at atol 2e-5; at llama3_1b
             the dq and dk/dv kernels and the plain versions (flash dq and
             dk/dv, and splash dk/dv at window 0) against fp64 sums per
             head, at the same limit; the readings of planted faults (one
             tile dropped), which that limit must fail;
             times at llama3_1b beside the plain versions', SDPA's and the
             bounds, dq and dk/dv also on a do of bf16 values. On bf16
             inputs at D 32/64/128 all three run on tensor cores (mma.sync
             with split-bf16 operands, so that the products stay exact);
             fp32 inputs and other head dims run on CUDA cores. The log
             names the instantiation each launch runs;
4. serve   - the serving engine on llama3_8b (full width and depth, bf16,
             synthetic weights from a seeded torch.Generator) answers 16
             requests through EngineRunner.submit, whole-prompt and with
             prefill_chunk=512; the kernels' launch counts must match the
             decode steps and chunk steps of that run; then torch.profiler
             over a prefill step, five decode steps and one chunk step (16
             mid-prefill slots at prefill_chunk=512) says where the time
             goes, the decode kernels' share of the decode steps and the
             chunk kernel's share of a chunk step; then the serving
             example's engine flags (quant fp8 through
             quantize_serve_params(consume=True), prefix cache,
             prefill_chunk=512, spec_tokens=4): 16 requests sharing a
             1024-token prefix in two waves, the chunk kernel launched
             exactly layers x (chunk-prefill + verify steps), the decode
             kernel never, a prefix hit rate above 0; the fp8 tree's bytes
             against bf16's, and verify and decode step times, bf16 and
             fp8, each with torch.profiler over one more step;
5. identity- in fp32 (llama3_8b width, 2 layers) the kernel engine is
             token-identical to the plain engine, whole-prompt and chunked,
             and to the full-forward greedy reference on two prompts; and
             with the prefix cache, chunked prefill and spec_tokens=4 to the
             plain engine with them and without them: two waves sharing a
             prefix, a pool that forces preemption, a model that repeats
             tokens (so that verify accepts drafts), and int8 on both sides;
             then the draft-head engine (a seeded random head, spec_tokens=4,
             on the kernels) against greedy decoding, in two waves with the
             prefix cache and chunked prefill, and under preemption;
6. http    - create_serve_app on 127.0.0.1: POST /generate streamed and
             buffered, GET /stats; an app on the example's engine flags sends
             X-Dstack-Prefix-Hit-Rate and X-Dstack-Spec-Accept-Rate, and
             /stats its live values;
7. train   - llama3_1b at full width and depth (fp32 masters, bf16
             activations, remat "full", attn_impl=flash, batch 2, seq 8192)
             trains 5 steps through train.train, with grad_accum=1 and 2: the
             loss is finite and falls, and the flash launches are exactly
             2 x layers x microbatches x steps (forward, and again under
             remat) and layers x microbatches x steps (dq, dk/dv); then
             torch.profiler over one step;
8. train identity - fp32, llama3_1b width with 2 layers, seq 1024: 3 steps
             with attn_impl=flash (the kernels) against attn_impl=blockwise
             (plain PyTorch) from the same parameters and batches; then
             attention_core's flash, flash_tpu and auto routes launch the
             kernels at T = 1024, 1000 and 63 on bf16 inputs;
9. splash  - the splash forward, dq and dk/dv kernels against their plain
             versions at llama3_1b heads, T 8192 bf16, windows 4096, 0 and
             1024 and 4096 with four packed documents, plus fp32 (T 1024),
             a ragged T = 72, causal=False with documents, D 96 (the
             CUDA-core kernels at bf16) with documents, and the handoff
             distillation's B 2, T 2048, window 4096, all at atol
             2e-5; at window 4096 dq, dk/dv and their plain versions against
             fp64 sums per head (fp32 and bf16-valued do), at the same
             limit; the readings of planted band faults (the first or last
             live tile of each band dropped, at each kernel's own row and
             key tile edges), which that limit must fail; splash at window
             0 against the flash kernels; per window the times beside the
             plain versions', SDPA's under the same mask and the bounds
             (dq and dk/dv also on a do of bf16 values); the window-1024
             forward and dq under 0.4x their window-0 times. On bf16 inputs
             at D 32/64/128 all three run on tensor cores, on the bodies
             flash runs under the band mask; fp32 inputs and other head dims
             run on CUDA cores. The log names the instantiation each launch
             runs;
10. train splash - train.main with the training example's flags
             (--attn-impl splash --attn-window 4096 --grad-accum 4
             --mu-dtype bfloat16 --remat-policy full --prefetch 2, llama3_1b,
             seq 8192, batch 8, 3 steps): losses finite and falling, splash
             launches exactly 2 x 16 x 4 x 3 / 16 x 4 x 3 / 16 x 4 x 3 and no
             flash launch; then train.train at batch 2, grad_accum 1, 5
             steps, window 4096, with torch.profiler over the last step;
11. splash identity - fp32, llama3_1b width with 2 layers, seq 1024,
             window 256: 3 steps on the splash kernels against 3 on
             splash_reference, with the fp32 and the bf16 first moment; the
             splash route launches the forward kernel at T = 1000 and 63;
12. handoff - the trainer-to-server handoff on llama3_1b at full width and
             4 of its 16 layers (DEPTH_CUTS: phases 12-14 run llama3_1b at 4
             layers and llama3_8b at 8 of 32, in their child processes too,
             so that the script with phase 16 stays inside its time limit)
             depth. Training's quantized products at its wq, w_gate and
             w_down shapes on 16384 rows: fp8_matmul (torch._scaled_mm,
             fp32 output and accumulation) within FP8_LIMIT of fp64 sums of
             the same e4m3 operands, two planted faults (a bf16 rounding
             before the scales, one row's scale dropped) beyond it; exact
             int8 sums (torch._int_mm), equal to the CPU's on 128 rows; the
             straight-through gradients against the fp32 ones; the fp8,
             int8 and bf16 products' times. Then, each in a child process,
             train.main with the training example's flags and --quant fp8
             --checkpoint-every 2 --checkpoint-dir D --resume --steps 4, on
             a seeded token file (--data, whose windows every mesh reads
             alike):
             crashed at step 3 (DSTACK_TPU_TRAIN_CRASH_AT_STEP), resumed at
             step 2, and its losses at steps 3 and 4 bit-equal to the same
             run without checkpoints (and the crashed run's 1-3), exact
             splash launches, the checkpoint and restart marks; train.main
             --draft-head distilling against the step-4 target (saved at
             step 12, the loss falls, one splash forward a layer and step);
             the served .params, read back from step 12, carry the per-leaf
             fp64 sums and sums of squares of the resumed run's parameters
             in memory after its last step; then
             serve.main with the serving example's flags (--quant fp8
             --prefix-cache --prefill-chunk 512 --spec-tokens 4) and
             --checkpoint-dir D --spec-model D on phase 4's two-wave traffic,
             the chunk kernel launched exactly layers x (chunk-prefill +
             verify steps) times and the decode kernel never, beside the
             head without its fallback and the n-gram proposer;
13. mesh   - the training mesh on llama3_1b at full width, phase 12's depth:
             phase 12's command line through train.main in child processes
             under torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK,
             MASTER_ADDR/PORT; NCCL, one card a rank), each with a timeout,
             so a hung collective fails the phase. (a) Up to two cards as
             ranks (--tp 1, no rings: JAX refuses them on one device; the
             batch of 8 in 4 microbatches has 2 rows a microbatch), 2 steps,
             a checkpoint at step 2: on one rank the losses bit-equal to phase
             12's meshless run (on two within 3e-3, the CPU tests' fp8
             limit), the manifest's mesh and process count, the telemetry's
             run_start mesh and proc, collective_wait_s on step points only
             with several ranks, exact splash launches, step 2's time and
             the peak against the meshless run's; (b) the mesh's step-2
             checkpoint resumed meshless and that run's step-3 checkpoint
             resumed on the mesh, bit-equal to the meshless run on one
             rank; (c) with two cards or more, --tp 2 --tp-overlap
             (--fsdp-overlap too on four) against (a), and each ring against
             its plain collective at llama3_1b's shapes (outputs of the fp
             products within 2^-7 of the largest, times with fp8 partials);
             on one card it logs "mesh multi-rank: not run";
14. serve mesh - the serving example's command line on the serve mesh
             (llama3_8b at 8 of its 32 layers, llama3_1b at phase 12's 4):
             serve.main in child processes under torchrun's environment,
             each with a timeout, against meshless serve.main servers on the
             same HTTP traffic (phase 4's two-wave burst at llama3_8b,
             phase 12's at llama3_1b, each request sent once the one before
             has its first token). (a) --mesh tp1 on one NCCL rank,
             llama3_8b with the example's engine flags: streams
             token-identical to meshless, /stats "mesh" dd1xtp1, the chunk
             kernel launched exactly layers x (chunk-prefill + verify
             steps), the decode kernel never, TTFT/ITL beside meshless.
             (b) four ranks sharing the card over gloo (each joins its
             group itself, LOCAL_RANK 0; gloo's all-reduce and broadcast of
             CUDA tensors and the card's compute mode probed first; an
             exclusive compute mode logs "serve mesh tp4 on one card: not
             run"): fp32 llama3_8b width with 2 layers at tp4 on the
             kernels token-identical to the meshless kernel engine,
             whole-prompt, chunked, with the prefix cache and spec_tokens=4,
             and int8; then in bf16 phase 12's checkpoint with the whole
             command line (--config llama3_1b --checkpoint-dir D
             --spec-model D --mesh tp4: each rank's restored pieces carry
             the fp64 sums of the checkpoint's slices) and llama3_8b's
             synthetic weights at --mesh tp4: exact chunk launches on every
             rank, KV pools a quarter a rank, the share of streams equal to
             meshless; rows 4 and 5 at a rank's heads (llama3_8b tp4 and
             tp2, llama3_1b tp4) against their plain versions at phase 2's
             limits, with times and bounds at llama3_8b tp4. (c) with four
             cards, llama3_8b --mesh tp4 over NCCL: TTFT, ITL, tokens/s and
             peak memory a rank beside meshless; on one card it logs "serve
             mesh multi-card: not run".
15. moe     - mixture-of-experts training. (a) The MoE example's command
             line, train.main --config moe_test --steps 100, in a child
             process (ep 1, blockwise): losses finite and falling, step p50.
             (b) Mixtral-8x7B width (d_model 4096, d_ff 14336, 32/8 heads,
             8 experts, top-2, vocab 32000, loss_chunk 512) at 2 of its 32
             layers, fp32 masters, bf16 activations, flash, remat full,
             batch 2 x 4096, 5 steps through train.train: losses finite and
             falling, flash launches exactly 2 x layers x steps (forward)
             and layers x steps (dq, dk/dv), the token drop rate, step p50,
             tokens/s, a model-FLOPs share of the phase's own reckoning
             (6 x active params + causal attention), the peak beside the
             reckoned fp32 TrainState, and torch.profiler over the last
             step (the MoE regions, flash, GEMM, copy and optimizer kernels,
             device busy). (c) fp32 at Mixtral width, 1 layer, seq 1024: 3
             steps on the flash kernels against 3 on the blockwise walk,
             losses and grad norms within 1e-5; one --quant int8 step,
             finite. (d) --checkpoint-every 2 --resume, crashed at step 3
             and resumed: steps 3-4 bit-equal to (a). (e) --ep 1 on one
             NCCL rank bit-equal to (a); four processes sharing the card
             over gloo (the four collectives on CUDA tensors probed first;
             a refusal logs "moe mesh on one card: not run"), fp32 moe_test
             at ep 4 and dp 2 x ep 2 within 1e-5 of meshless; with four
             cards, Mixtral width at 2 layers --ep 4 over NCCL (step times,
             the dispatch all-to-all, peak a rank); on one card it logs
             "moe multi-card: not run".
16. mesh axes - the pipeline, sequence and MoE-tensor axes. (a) GPipe
             (pipeline.pipelined_loss_fn) on llama3_1b at full width and
             DEPTH_CUTS' depth (4 of 16 layers; fp32 masters, bf16
             activations, remat full, flash, batch 2 x 8192, 2
             microbatches) over pp 2 as two processes
             sharing the card over gloo, against meshless loss_fn on the
             same parameters and batch in a process of its own: the loss
             within 1e-3 relative, each leaf's gradient norm (a layer
             leaf's by stage) within 1%, the flash launches a rank exactly
             2 layers x 2 microbatches x 2 (forward, and again under remat)
             and 2 x 2 (dq, dk/dv), the forward-and-backward time and the
             peak a rank beside meshless; then fp32 at 2 layers, seq 1024,
             every gradient piece within 1e-5 of its leaf's largest value.
             (b) ring attention over sp 2 (two processes on the card,
             blockwise): 2 steps of train.train on llama3_1b (4 layers),
             batch 2 x 8192, against meshless within 1e-3 relative; fp32
             at 2 layers, seq 1024, 3 steps within 1e-5. (c) MoE under tp: fp32 Mixtral
             width at 1 layer, seq 1024, ep 1 x tp 2 on two processes, and
             moe_test at ep 2 x tp 2 on four, 2 steps each within 1e-5 of
             meshless. (d) python -m dstack_tpu_torch.dryrun 16 on the
             card: JAX's four dry-run lines and the entry point's forward.
             (e) with four cards over NCCL, GPipe at pp 4 (batch 4 x 8192,
             4 microbatches) and the ring at sp 4 (seq 32768): times and
             peaks a rank; on one card it logs "mesh axes multi-card: not
             run". gloo's times on one card are host copies: correctness
             only.
17. last paths - (a) the tile menu (kernels/flash.py TILE_MENU): a
             pair off the menu and a tile edge the library is not built at
             raising, every pair's flash and splash kernels (W 4096, with
             and without four documents) against their plain versions at
             llama3_1b heads (T 8192 bf16) and at D 64, at atol 2e-5, dq
             and dk/dv at every pair against fp64 sums per head, the planted
             tile and band faults at each pair's own edges, each pair's
             times. Every main-path launch of the other phases ran at the
             default pair, or the run fails. (b)
             train.main with phase 10's flags and --autotune in a fresh
             autotune directory: the sweep's line and cache entry, every
             splash launch exact and at the pair it ran, losses finite and
             falling; one more step without --autotune reads the cache and
             sweeps nothing. (c) the remat policies full, dots and save_proj
             on llama3_1b (flash, batch 2 x 8192, 3 steps each): losses
             within 1e-4 of full's, step time, peak memory, exact flash
             launches; save_proj against full in fp32 at 2 layers within
             1e-6. (d) --draft-head under torchrun at world 1 (NCCL)
             against meshless, bit for bit; moe_test under sp 2 and with the
             all-gather ring at fsdp 2 as two gloo processes on the card
             within 1e-5 of meshless; the draft head at fsdp 2 x tp 2 over
             NCCL when four cards are visible.

The line before the last is a JSON object with each kernel's launches, error
and times; the last line is {"ok": true, "device": {...}}. Exits non-zero
without printing a result when no CUDA device is present.
"""

from __future__ import annotations

import asyncio
import gc
import json
import logging
import os
import subprocess
import sys
import threading
import time

import numpy as np

# Published peaks of one H100 SXM at its full 700 W limit (NVIDIA data sheet).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = 67e12

KERNEL_SOURCE = "dstack_tpu_torch/workloads/kernels/csrc/paged_attention.cu"
FLASH_SOURCE = "dstack_tpu_torch/workloads/kernels/csrc/flash_attention.cu"
SPLASH_SOURCE = "dstack_tpu_torch/workloads/kernels/csrc/splash_attention.cu"
# llama3_8b attention geometry and the serving example's pool.
H, KH, D, PAGE, POOL, SLOTS, TABLE = 32, 8, 128, 16, 4096, 16, 512
CHUNK = 512
KV_LENS = [0, 1, 15, 16, 17, 1000, 4095, 8192, 0, 1, 15, 16, 17, 1003, 4095, 8192]
# The prompt lengths of phase_serve's burst of 16 requests.
BURST_LENGTHS = [int(n) for n in np.linspace(16, 1500, 16).astype(int)]
# Valid chunk tokens per slot; chunk slot s starts at KV_LENS[s] - VALID[s].
VALID = [0, 1, 15, 13, 17, 488, 495, 512, 0, 1, 10, 16, 5, 300, 512, 100]
# The serving example's speculative decode: each verify step is a chunk of
# SPEC_TOKENS + 1 rows a slot, of which 1..5 are valid (a request's budget
# clips its last rows).
SPEC_TOKENS = 4
# Readings one phase hands to a later one.
MEASURED = {}
VERIFY_VALID = [1, 2, 3, 4, 5] * 3 + [5]


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def demangle(names: list) -> dict:
    """Kernel names as the toolkit's cu++filt (beside nvcc) gives them,
    without parameter lists; where it is missing or fails, as ptxas gives
    them."""
    from pathlib import Path

    from dstack_tpu_torch.workloads.kernels import build

    tool = Path(build.find_nvcc()).with_name("cu++filt")
    same = {n: n for n in names}
    if not names or not tool.is_file():
        return same
    out = subprocess.run([str(tool), "-p", *names], capture_output=True, text=True, timeout=60)
    lines = out.stdout.splitlines()
    if out.returncode or len(lines) != len(names):
        return same
    return {n: line.replace("(anonymous namespace)::", "") for n, line in zip(names, lines)}


def ptxas_summary(text: str) -> list:
    """One line per kernel from nvcc's -Xptxas -v output: registers, spill
    stores and loads, stack."""
    import re

    found, name, usage = [], None, {}
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            usage[name] = f"stack {m.group(1)} B, spill stores {m.group(2)} B, loads {m.group(3)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            found.append((name, f"{m.group(1)} registers, {usage.get(name, 'no spill line')}"))
    names = demangle([n for n, _ in found])
    return [f"{names[n]}: {line}" for n, line in found]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, from CUDA events around each call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def fresh_peak() -> None:
    """Start a peak-memory reading from the live tensors alone: the engines
    of earlier phases sit in reference cycles, and until the collector
    frees them their weights and pools count toward the next peak."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()


def device_ms(fn, iters: int = 20) -> float:
    """Device time of one call: the summed time of the kernels it launches,
    from torch.profiler over ``iters`` calls after a warm-up. For calls
    shorter than their own host work, where CUDA events around a call time
    the host."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    # A profiler session can come back without device events; take the
    # next one then, and fail after three.
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if str(e.device_type).endswith("CUDA"))
        if total > 0:
            return total / 1e3 / iters
    raise RuntimeError("torch.profiler recorded no device time in three sessions")


# record_function ranges that the profiler also puts on the device timeline:
# the optimizer's step, the profiler's steps, the MoE regions.
ANNOTATIONS = ("Optimizer.", "ProfilerStep", "moe.")


def device_kernels(events) -> list:
    """The kernel rows of a profile's ``key_averages()``: device rows with
    time, less the spans of record_function ranges on the device timeline,
    which would count their whole span as busy time."""
    return [e for e in events if str(e.device_type).endswith("CUDA")
            and e.self_device_time_total > 0 and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith(ANNOTATIONS)]


# -- phase 2: kernels --------------------------------------------------------


def kernel_inputs(dtype, seed: int = 0, lens=KV_LENS, h: int = H, kh: int = KH):
    """Pages from a shuffled pool (non-contiguous page ids), tables zero past
    each slot's pages (slot s holds lens[s] positions), and the chunk
    geometry's starts; q of ``h`` heads, pages of ``kh``."""
    import torch

    rng = np.random.RandomState(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    k_pages = torch.randn((POOL, PAGE, kh, D), generator=gen, device="cuda").to(dtype)
    v_pages = torch.randn((POOL, PAGE, kh, D), generator=gen, device="cuda").to(dtype)
    perm = rng.permutation(POOL)
    table = np.zeros((SLOTS, TABLE), np.int32)
    used = 0
    for s, n in enumerate(lens):
        pages = -(-n // PAGE)
        table[s, :pages] = perm[used:used + pages]
        used += pages
    kv_lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    starts = torch.tensor(
        [n - v for n, v in zip(KV_LENS, VALID)], dtype=torch.int32, device="cuda"
    )
    q1 = torch.randn((SLOTS, h, D), generator=gen, device="cuda").to(dtype)
    qc = torch.randn((SLOTS, CHUNK, h, D), generator=gen, device="cuda").to(dtype)
    return dict(
        q1=q1, qc=qc, k_pages=k_pages, v_pages=v_pages,
        table=torch.from_numpy(table).cuda(), kv_lens=kv_lens, starts=starts,
    )


def dense_kv(x, lens=KV_LENS):
    """Gathered dense K and V [S, H, T, D] over the longest slot, for the
    library yardstick only."""
    t = max(lens)
    h, kh = x["q1"].shape[1], x["k_pages"].shape[2]
    idx = x["table"][:, : -(-t // PAGE)].long()
    out = []
    for pages in (x["k_pages"], x["v_pages"]):
        dense = pages[idx].reshape(SLOTS, -1, kh, D)[:, :t]
        out.append(dense.repeat_interleave(h // kh, dim=2).transpose(1, 2).contiguous())
    return out


def kernel_bounds(x):
    """(bound_ms, bound_by) of each kernel for these inputs: the K/V
    positions each needs read once, q read once, fp32 out written once; the
    score and PV operations each row needs, at the bf16 tensor-core rate."""
    item = x["k_pages"].element_size()
    h, kh = x["q1"].shape[1], x["k_pages"].shape[2]
    kv_token = 2 * kh * D * item
    lens = np.asarray(KV_LENS, np.int64)
    starts = lens - np.asarray(VALID, np.int64)
    rows = np.arange(CHUNK)
    visible = np.clip(np.minimum(lens[:, None], starts[:, None] + rows[None, :] + 1), 0, None)
    out = {}
    for name, q_elems, tokens, attended in (
        ("paged_decode_attention", SLOTS * h * D, lens.sum(), lens.sum()),
        ("paged_chunk_attention", SLOTS * CHUNK * h * D, visible.max(1).sum(), visible.sum()),
    ):
        nbytes = q_elems * item + tokens * kv_token + q_elems * 4 + SLOTS * 4 * 2
        flops = 4.0 * attended * h * D
        peak = BF16_FLOP_PER_S if item == 2 else FP32_FLOP_PER_S
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
        out[name] = (
            float(max(t_bytes, t_ops) * 1e3), "bytes" if t_bytes >= t_ops else "operations"
        )
    return out


def log_instantiations(module, names, tensor_core, require=None) -> None:
    """Print what each wrapper runs at bf16 D 128, fp32 D 128 and bf16 D 96,
    and fail unless the wrappers in ``tensor_core`` run on tensor cores
    exactly at bf16 D 128 and the others never do, and unless every
    instantiation of a wrapper named in ``require`` names the kernel given
    there."""
    import torch

    for name in names:
        for dtype, d in ((torch.bfloat16, 128), (torch.float32, 128), (torch.bfloat16, 96)):
            desc = module.instantiation(name, dtype, d)
            log(f"kernel {name} {str(dtype)[6:]} D={d} runs: {desc}")
            want = name in tensor_core and dtype == torch.bfloat16 and d == 128
            if desc.startswith("bf16 tensor cores") != want:
                raise AssertionError(f"{name} {dtype} D={d} runs {desc}")
            if require and name in require and require[name] not in desc:
                raise AssertionError(f"{name} {dtype} D={d} runs {desc}, not {require[name]}")


def paged_planted_faults(label, x, atol, rtol) -> None:
    """What a chunk kernel with an off-by-one would read against the plain
    version, computed by the plain version on shifted inputs: the walk one
    page short (each slot's kv_len cut back to the start of its last page,
    so every row that sees into that page loses it) and the causal edge one
    position late (starts + 1: row i also sees position start + i + 1 where
    the slot holds it). Each reading, in units of the limit (|fault - plain|
    / (atol + rtol |plain|), which assert_close fails above 1), must lie
    over 10."""
    import torch

    from dstack_tpu_torch.workloads.kernels import paged

    args = (x["qc"], x["k_pages"], x["v_pages"], x["table"])
    lens, starts = x["kv_lens"], x["starts"]
    ref = paged.paged_chunk_attention_plain(*args, starts, lens)
    short = torch.where(lens > 0, (lens - 1) // PAGE * PAGE, lens)
    faults = {"the walk one page short": paged.paged_chunk_attention_plain(*args, starts, short),
              "the causal edge one position late":
                  paged.paged_chunk_attention_plain(*args, starts + 1, lens)}
    for fault, got in faults.items():
        diff = (got - ref).abs()
        err = float(diff.max())
        excess = float((diff / (atol + rtol * ref.abs())).max())
        if not excess > 10:
            raise AssertionError(f"paged_chunk_attention {label}: {fault} reads {err:.3e},"
                                 f" {excess:.2f}x the limit")
        log(f"planted fault paged_chunk_attention {label} ({fault}): max |fault - plain|"
            f" {err:.3e} = {excess:.0f}x the limit (atol {atol:g}, rtol {rtol:g}); the check"
            f" fails it")


def paged_decode_planted_faults(label, x, atol, rtol) -> None:
    """What a split-KV decode kernel with an off-by-one would read against
    the plain version, computed by the plain version on shortened kv_lens:
    the last split of each slot dropped (kv_len cut back to the start of its
    last split of ``paged.decode_split`` positions, which loses the split
    bounds or the combine's last split) and the last position dropped
    (kv_len - 1). Each reading over the slots with kv_len > 0, in units of
    the limit, must lie over 10."""
    import torch

    from dstack_tpu_torch.workloads.kernels import paged

    args = (x["q1"], x["k_pages"], x["v_pages"], x["table"])
    lens = x["kv_lens"]
    active = lens > 0
    split = paged.decode_split(x["table"].shape[1] * PAGE)
    ref = paged.paged_decode_attention_plain(*args, lens)
    last = (lens - 1).clamp(min=0)
    faults = {f"the last split of {split} positions dropped": last // split * split,
              "the last position dropped": last}
    for fault, short in faults.items():
        got = paged.paged_decode_attention_plain(*args, short)
        diff = (got - ref)[active].abs()
        err = float(diff.max())
        excess = float((diff / (atol + rtol * ref[active].abs())).max())
        if not excess > 10:
            raise AssertionError(f"paged_decode_attention {label}: {fault} reads {err:.3e},"
                                 f" {excess:.2f}x the limit")
        log(f"planted fault paged_decode_attention {label} ({fault}): max |fault - plain|"
            f" {err:.3e} = {excess:.0f}x the limit (atol {atol:g}, rtol {rtol:g}); the check"
            f" fails it")


def decode_burst_timing(card: str) -> None:
    """Decode at the serving burst's lengths: phase_serve's 16 prompts
    (BURST_LENGTHS) at their 16th decode position, in the serving example's
    pool and table (bf16, llama3_8b heads); the kernel against its plain
    version (bf16 limits), its time beside SDPA's on the gathered K/V and the
    bytes bound, each as CUDA-event medians (time_ms) and as device time
    (device_ms)."""
    import torch

    from dstack_tpu_torch.workloads.kernels import paged

    lens = [n + 16 for n in BURST_LENGTHS]
    x = kernel_inputs(torch.bfloat16, seed=5, lens=lens)
    args = (x["q1"], x["k_pages"], x["v_pages"], x["table"], x["kv_lens"])
    got, ref = paged.paged_decode_attention_cuda(*args), paged.paged_decode_attention_plain(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-3)
    k_dense, v_dense = dense_kv(x, lens)
    pos = torch.arange(k_dense.shape[2], device="cuda")
    mask = (pos[None, :] < x["kv_lens"].long()[:, None])[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def kernel():
        return paged.paged_decode_attention_cuda(*args)

    def library():
        return sdpa(x["q1"][:, :, None, :], k_dense, v_dense, attn_mask=mask)

    ms, library_ms = time_ms(kernel), time_ms(library)
    dev_ms, library_dev_ms = device_ms(kernel), device_ms(library)
    bound_ms = sum(lens) * 2 * KH * D * 2 / HBM_BYTES_PER_S * 1e3
    err = float((got - ref).abs().max())
    log(f"kernel paged_decode_attention bf16 at the serving burst's lengths"
        f" ({min(lens)}..{max(lens)}, {sum(lens)} positions): max_abs_err {err:.3e} (atol 1e-4,"
        f" rtol 1e-3) ok; CUDA events {ms:.4f} ms, sdpa {library_ms:.4f} ms; device time"
        f" {dev_ms:.4f} ms, sdpa {library_dev_ms:.4f} ms; bound {bound_ms:.4f} ms (bytes: K/V"
        f" read once), {dev_ms / bound_ms:.1f}x by device time [{card}]")
    del x, k_dense, v_dense
    torch.cuda.empty_cache()


def paged_shapes() -> dict:
    """The chunk and decode kernels off the serving example's geometry,
    against their plain versions (bf16, atol 1e-4 / rtol 1e-3): pages of 12
    rows (a tile gathers across page boundaries, and the decode kernel's
    float page quotient is not exact), 32 and 64 rows, D 64, 32 and 96 (the
    decode kernel's scalar loads), n_rep 1, 2 and 8 (decode warps without a
    head), and page 16 at D 128 with n_rep 2 (llama3_1b's heads, which the
    handoff serves); three slots (kv_len 0; 90; 300, across the decode split
    edge at 256), the chunk's 100 rows from position 0, 0 and 250, in a
    shuffled pool. Returns each kernel's largest error over these shapes."""
    import torch

    from dstack_tpu_torch.workloads.kernels import paged

    lens = torch.tensor([0, 90, 300], dtype=torch.int32, device="cuda")
    starts = torch.tensor([0, 0, 250], dtype=torch.int32, device="cuda")
    worst = {}
    for page, d, n_rep in ((12, 128, 4), (16, 64, 1), (32, 32, 2), (64, 128, 8), (16, 96, 4),
                           (16, 128, 2)):
        gen = torch.Generator(device="cuda").manual_seed(page)
        n_pages = -(-300 // page)
        pool = 3 * n_pages + 2
        k_pages, v_pages = (torch.randn((pool, page, 2, d), generator=gen, device="cuda").bfloat16()
                            for _ in range(2))
        table = torch.from_numpy(
            np.random.RandomState(page).permutation(pool)[:3 * n_pages].reshape(3, n_pages)
        ).int().cuda()
        qc = torch.randn((3, 100, 2 * n_rep, d), generator=gen, device="cuda").bfloat16()
        q1 = torch.randn((3, 2 * n_rep, d), generator=gen, device="cuda").bfloat16()
        for name, args, kernel, plain in (
            ("paged_chunk_attention", (qc, k_pages, v_pages, table, starts, lens),
             paged.paged_chunk_attention_cuda, paged.paged_chunk_attention_plain),
            ("paged_decode_attention", (q1, k_pages, v_pages, table, lens),
             paged.paged_decode_attention_cuda, paged.paged_decode_attention_plain),
        ):
            got, ref = kernel(*args), plain(*args)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-3)
            if bool(got[0].abs().max() != 0):
                raise AssertionError(f"{name} page {page}: kv_len 0 rows are not zero")
            err = float((got - ref).abs().max())
            worst[name] = max(worst.get(name, 0.0), err)
            log(f"kernel {name} bf16 page {page} D={d} n_rep {n_rep}: max_abs_err"
                f" {err:.3e} (atol 1e-4, rtol 1e-3) ok")
    return worst


def verify_bound(starts, lens, c: int, item: int, h: int = H, kh: int = KH):
    """(bound_ms, bound_by) of a chunk call of c rows a slot: q read once,
    each slot's K/V positions read once, fp32 out written once; the score and
    PV operations of every row (rows past valid attend kv_len positions, as
    the kernel's do), at the bf16 tensor-core or fp32 rate."""
    starts, lens = np.asarray(starts, np.int64), np.asarray(lens, np.int64)
    rows = np.arange(c)
    attended = np.minimum(lens[:, None], starts[:, None] + rows[None, :] + 1).sum()
    q_elems = len(lens) * c * h * D
    nbytes = q_elems * item + lens.sum() * 2 * kh * D * item + q_elems * 4 + len(lens) * 4 * 2
    peak = BF16_FLOP_PER_S if item == 2 else FP32_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 4.0 * attended * h * D / peak
    return float(max(t_bytes, t_ops) * 1e3), "bytes" if t_bytes >= t_ops else "operations"


def verify_shapes(card: str, h: int = H) -> dict:
    """The chunk kernel at speculative verify's shape: 16 slots whose chunks
    start at the serving burst's lengths, C = SPEC_TOKENS + 1 = 5 rows with
    1..5 valid (kv_lens = starts + valid), and at C = 3 and 1; at llama3_8b
    heads (n_rep 4) these are 20, 12 and 4 rows of the tensor-core kernel's
    64-row fold, at llama3_1b heads (h 16, n_rep 2) 10, 6 and 2. Against the
    plain version on the rows i < valid that verify reads (ROADMAP C), bf16
    at atol 1e-4 / rtol 1e-3 and fp32 at 1e-5; each launch's instantiation
    logged. At llama3_8b heads, C = 5 bf16: times (CUDA events and device
    time) beside the plain version's, SDPA's on the gathered K/V and the
    bound. Returns those, or at other heads the largest error of the bf16
    and fp32 cases."""
    import torch

    from dstack_tpu_torch.workloads.kernels import paged

    out = {} if h == H else {f"verify_h{h}_max_abs_err": 0.0}
    for c in (SPEC_TOKENS + 1, 3, 1):
        valid = [min(c, v) for v in VERIFY_VALID]
        lens = [n + v for n, v in zip(BURST_LENGTHS, valid)]
        for dtype, atol, rtol in ((torch.float32, 1e-5, 1e-5), (torch.bfloat16, 1e-4, 1e-3)):
            x = kernel_inputs(dtype, seed=10 + c, lens=lens, h=h)
            q = x["qc"][:, :c].contiguous()
            starts = torch.tensor(BURST_LENGTHS, dtype=torch.int32, device="cuda")
            args = (q, x["k_pages"], x["v_pages"], x["table"], starts, x["kv_lens"])
            got, ref = paged.paged_chunk_attention_cuda(*args), paged.paged_chunk_attention_plain(*args)
            torch.cuda.synchronize()
            rows = (torch.arange(c, device="cuda")[None, :]
                    < torch.tensor(valid, device="cuda")[:, None])
            if not bool(torch.isfinite(got[rows]).all()):
                raise AssertionError(f"paged_chunk_attention verify C={c}: non-finite output")
            torch.testing.assert_close(got[rows], ref[rows], atol=atol, rtol=rtol)
            err = float((got[rows] - ref[rows]).abs().max())
            desc = paged.instantiation("paged_chunk_attention", dtype, D)
            log(f"kernel paged_chunk_attention {str(dtype)[6:]} verify C={c} (16 slots from the"
                f" burst's lengths, valid {min(valid)}..{max(valid)}, h {h}, {c * h // KH} folded"
                f" rows): max_abs_err {err:.3e} on rows i < valid (atol {atol:g}, rtol {rtol:g})"
                f" ok; runs {desc}")
            if h != H:
                key = f"verify_h{h}_max_abs_err"
                out[key] = max(out[key], err)
            elif dtype == torch.bfloat16 and c == SPEC_TOKENS + 1:
                k_dense, v_dense = dense_kv(x, lens)
                pos = torch.arange(k_dense.shape[2], device="cuda")
                limit = torch.minimum(x["kv_lens"].long()[:, None],
                                      starts.long()[:, None] + torch.arange(c, device="cuda") + 1)
                mask = (pos[None, None, :] < limit[:, :, None])[:, None]
                q_t = q.transpose(1, 2)
                sdpa = torch.nn.functional.scaled_dot_product_attention

                def kernel():
                    return paged.paged_chunk_attention_cuda(*args)

                def library():
                    return sdpa(q_t, k_dense, v_dense, attn_mask=mask)

                out = {"verify_max_abs_err": err, "verify_ms": time_ms(kernel),
                       "verify_device_ms": device_ms(kernel),
                       "verify_plain_ms": time_ms(lambda: paged.paged_chunk_attention_plain(*args)),
                       "verify_library_ms": time_ms(library)}
                out["verify_bound_ms"], out["verify_bound_by"] = verify_bound(
                    BURST_LENGTHS, lens, c, 2)
                log(f"kernel paged_chunk_attention bf16 verify C={c} timing: CUDA events"
                    f" {out['verify_ms']:.4f} ms, device time {out['verify_device_ms']:.4f} ms,"
                    f" plain {out['verify_plain_ms']:.4f} ms, sdpa {out['verify_library_ms']:.4f}"
                    f" ms, bound {out['verify_bound_ms']:.4f} ms ({out['verify_bound_by']}),"
                    f" {out['verify_device_ms'] / out['verify_bound_ms']:.1f}x by device time"
                    f" [{card}]")
                del k_dense, v_dense
            del x
            torch.cuda.empty_cache()
    return out


def phase_kernels(card: str) -> dict:
    import torch

    from dstack_tpu_torch.workloads.kernels import paged

    log_instantiations(paged, paged.launches, {"paged_chunk_attention"},
                       require={"paged_decode_attention": "paged_decode_split_kernel"})
    report = {}
    for dtype, atol, rtol in ((torch.float32, 1e-5, 1e-5), (torch.bfloat16, 1e-4, 1e-3)):
        x = kernel_inputs(dtype)
        args_d = (x["q1"], x["k_pages"], x["v_pages"], x["table"], x["kv_lens"])
        args_c = (x["qc"], x["k_pages"], x["v_pages"], x["table"], x["starts"], x["kv_lens"])
        pairs = {
            "paged_decode_attention": (
                lambda: paged.paged_decode_attention_cuda(*args_d),
                lambda: paged.paged_decode_attention_plain(*args_d),
            ),
            "paged_chunk_attention": (
                lambda: paged.paged_chunk_attention_cuda(*args_c),
                lambda: paged.paged_chunk_attention_plain(*args_c),
            ),
        }
        for name, (kernel, plain) in pairs.items():
            got, ref = kernel(), plain()
            torch.cuda.synchronize()
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"{name} ({dtype}): non-finite output")
            err = float((got - ref).abs().max())
            torch.testing.assert_close(got, ref, atol=atol, rtol=rtol)
            zero_rows = [s for s, n in enumerate(KV_LENS) if n == 0]
            if bool(got[zero_rows].abs().max() != 0):
                raise AssertionError(f"{name} ({dtype}): kv_len 0 rows are not zero")
            log(f"kernel {name} {str(dtype)[6:]}: max_abs_err {err:.3e}"
                f" (atol {atol:g}, rtol {rtol:g}) ok")
            if dtype == torch.bfloat16:
                report[name] = {"max_abs_err": err, "kernel": kernel, "plain": plain}
        paged_planted_faults(str(dtype)[6:], x, atol, rtol)
        paged_decode_planted_faults(str(dtype)[6:], x, atol, rtol)
        if dtype == torch.bfloat16:
            bounds = kernel_bounds(x)
            k_dense, v_dense = dense_kv(x)
            t = k_dense.shape[2]
            pos = torch.arange(t, device="cuda")
            lens = x["kv_lens"].long()
            mask_d = (pos[None, :] < lens[:, None])[:, None, None, :]
            q_d = x["q1"][:, :, None, :]
            rows = torch.arange(CHUNK, device="cuda")
            limit = torch.minimum(lens[:, None], x["starts"].long()[:, None] + rows[None, :] + 1)
            mask_c = (pos[None, None, :] < limit[:, :, None])[:, None]
            q_c = x["qc"].transpose(1, 2)
            sdpa = torch.nn.functional.scaled_dot_product_attention
            library = {
                "paged_decode_attention": lambda: sdpa(q_d, k_dense, v_dense, attn_mask=mask_d),
                "paged_chunk_attention": lambda: sdpa(q_c, k_dense, v_dense, attn_mask=mask_c),
            }
            for name, entry in report.items():
                kernel = entry.pop("kernel")
                entry["ms"] = time_ms(kernel)
                entry["plain_ms"] = time_ms(entry.pop("plain"))
                entry["library_ms"] = time_ms(library[name])
                entry["bound_ms"], entry["bound_by"] = bounds[name]
                device = ""
                if name == "paged_decode_attention":
                    # A decode call takes less device time than its wrapper's
                    # host work, so the events around it read the host as
                    # well: the device time of its kernels (split and
                    # combine) and of SDPA's, beside the events' readings.
                    entry["device_ms"] = device_ms(kernel)
                    entry["library_device_ms"] = device_ms(library[name])
                    device = (f"; device time {entry['device_ms']:.4f} ms, sdpa"
                              f" {entry['library_device_ms']:.4f} ms,"
                              f" {entry['device_ms'] / entry['bound_ms']:.1f}x the bound")
                log(f"kernel {name} bf16 timing (CUDA events): {entry['ms']:.4f} ms, plain"
                    f" {entry['plain_ms']:.4f} ms, sdpa {entry['library_ms']:.4f} ms,"
                    f" bound {entry['bound_ms']:.4f} ms ({entry['bound_by']}),"
                    f" {entry['ms'] / entry['bound_ms']:.1f}x the bound{device}")
            del k_dense, v_dense
        del x
        torch.cuda.empty_cache()
    for name, err in paged_shapes().items():
        report[name]["shapes_max_abs_err"] = err
    decode_burst_timing(card)
    report["paged_chunk_attention"].update(verify_shapes(card))
    # llama3_1b's heads, which the handoff phase serves and verifies.
    report["paged_chunk_attention"].update(verify_shapes(card, h=16))
    return report


# -- phase 3: flash kernels ----------------------------------------------------

# (name, B, H, Kh, D, T) of the flash comparisons; the first is timed.
FLASH_GEOMETRIES = (("llama3_1b", 2, 16, 8, 128, 8192), ("llama3_8b", 2, 32, 8, 128, 8192))
# Tolerance of every flash comparison (o, lse, dq, dk, dv; bf16 and fp32
# inputs), absolute only. On bf16 inputs the three kernels run on tensor
# cores with each fp32 operand (p, ds, do) split into three bf16 terms and
# the six leading products of p^T do kept, so every product is exact and the
# kernels differ from an exact computation in the order and rounding of the
# sums alone (mma truncates each result toward zero). fp32 sums over the
# 16,384 queries of a llama3_1b KV head at T 8192, which the plain dk/dv
# versions took before, lie several times 1e-5 from the exact sums, so the
# plain dk/dv versions sum in fp64; flash_bwd_against_fp64 holds the dq and
# dk/dv kernels and their plain versions to this limit against an fp64
# computation and prints how far the fp32 dk/dv sums lie. The largest
# |kernel - plain| over these cases was 3.5e-6 (dk/dv at llama3_8b), 6x
# inside 2e-5.
# phase_flash also plants a fault (one tile dropped) and requires each
# reading to lie far outside this limit.
FLASH_TOL = 2e-5
# The kernels' tile edges: the forward's KV tiles, dq's KV tiles and dk/dv's
# q tiles. The fault plants drop one tile of this many rows.
FLASH_TILE = 64
FLASH_DQ_KV_TILE = 32
FLASH_DKV_Q_TILE = 32


def flash_inputs(b, h, kh, d, t, dtype, seed):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    q3 = torch.randn((b * h, t, d), generator=gen, device="cuda").to(dtype)
    k3 = torch.randn((b * kh, t, d), generator=gen, device="cuda").to(dtype)
    v3 = torch.randn((b * kh, t, d), generator=gen, device="cuda").to(dtype)
    do3 = torch.randn((b * h, t, d), generator=gen, device="cuda")
    return q3, k3, v3, do3


def flash_compare(label, q3, k3, v3, do3, causal) -> dict:
    """Each kernel against its plain version on the same inputs (the
    backward kernels on the plain forward's o and lse); max |error| each."""
    import torch

    from dstack_tpu_torch.workloads.kernels import flash

    dtype = str(q3.dtype)[6:]
    o, lse = flash.flash_fwd(q3, k3, v3, causal)
    ro, rlse = flash.flash_fwd_plain(q3, k3, v3, causal)
    delta = (do3 * ro).sum(-1)
    got = {"flash_fwd": (o, lse),
           "flash_bwd_dq": (flash.flash_bwd_dq(q3, k3, v3, do3, rlse, delta, causal),),
           "flash_bwd_dkv": flash.flash_bwd_dkv(q3, k3, v3, do3, rlse, delta, causal)}
    torch.cuda.synchronize()
    ref = {"flash_fwd": (ro, rlse),
           "flash_bwd_dq": (flash.flash_bwd_dq_plain(q3, k3, v3, do3, rlse, delta, causal),),
           "flash_bwd_dkv": flash.flash_bwd_dkv_plain(q3, k3, v3, do3, rlse, delta, causal)}
    errs = {}
    for name in got:
        errs[name] = 0.0
        for g, r in zip(got[name], ref[name]):
            if not bool(torch.isfinite(g).all()):
                raise AssertionError(f"{name} {label}: non-finite output")
            torch.testing.assert_close(g, r, atol=FLASH_TOL, rtol=0)
            errs[name] = max(errs[name], float((g - r).abs().max()))
        log(f"kernel {name} {label} {dtype} causal={causal}: max_abs_err"
            f" {errs[name]:.3e} (max |ref| {max(float(r.abs().max()) for r in ref[name]):.3g};"
            f" atol {FLASH_TOL:g}) ok")
    return errs


def flash_bwd_against_fp64(label, q3, k3, v3, do3, window=None, pairs=None) -> None:
    """dq and dk/dv against an exact computation: per KV head, scores, p, ds
    and the sums over every key (dq) and every query (dk, dv) in fp64 from
    the same inputs, lse and delta. With ``window`` None, the flash kernels:
    the tensor-core kernels, the plain versions and the splash plain dk/dv at
    window 0 (the yardsticks of every dq and dk/dv comparison) must each lie
    within FLASH_TOL of it; the plain dk/dv version's own p and ds summed by
    fp32 GEMMs, as the plain versions summed them before they took fp64
    sums, are read beside them with the device kernels those GEMMs ran, and
    not held to the limit: batched over the KV heads (the former form) and
    one KV head at a time. With a ``window``, the splash kernels under the
    causal band of that window (no documents): the tensor-core dq and dk/dv
    and their plain versions, held to the same limit. With ``pairs`` (menu
    pairs), the tensor-core kernels run at each pair beside the plain
    versions, and the fp32 drift readings are left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dstack_tpu_torch.workloads.kernels import flash, splash

    bkh, t, d = k3.shape
    n_rep = q3.shape[0] // bkh
    if window is None:
        ro, lse = flash.flash_fwd_plain(q3, k3, v3, True)
    else:
        ro, lse = splash.splash_fwd_plain(q3, k3, v3, None, None, True, window)
    delta = (do3 * ro).sum(-1)
    del ro
    args = (q3, k3, v3, do3, lse, delta)
    if pairs is not None:
        kind = splash if window is not None else flash
        prefix = "splash" if window is not None else "flash"
        extra = (None, None, True, window) if window is not None else (True,)
        names = (f"{prefix}_bwd_dq", f"{prefix}_bwd_dkv")
        dkv_fn, dq_fn = getattr(kind, names[1]), getattr(kind, names[0])
        runs = {f"kernel at {bq}x{bk}": dkv_fn(*args, *extra, (bq, bk)) for bq, bk in pairs}
        runs["plain version"] = getattr(kind, names[1] + "_plain")(*args, *extra)
        dq_runs = {f"kernel at {bq}x{bk}": dq_fn(*args, *extra, (bq, bk)) for bq, bk in pairs}
        dq_runs["plain version"] = getattr(kind, names[0] + "_plain")(*args, *extra)
    elif window is None:
        names = ("flash_bwd_dq", "flash_bwd_dkv")
        runs = {"tensor-core kernel": flash.flash_bwd_dkv(*args, True),
                "plain version": flash.flash_bwd_dkv_plain(*args, True),
                "splash plain version (window 0)": splash.splash_bwd_dkv_plain(*args, None, None,
                                                                              True, 0)}
        dq_runs = {"tensor-core kernel": flash.flash_bwd_dq(*args, True),
                   "plain version": flash.flash_bwd_dq_plain(*args, True)}
    else:
        names = ("splash_bwd_dq", "splash_bwd_dkv")
        band = (*args, None, None, True, window)
        runs = {"tensor-core kernel": splash.splash_bwd_dkv(*band),
                "plain version": splash.splash_bwd_dkv_plain(*band)}
        dq_runs = {"tensor-core kernel": splash.splash_bwd_dq(*band),
                   "plain version": splash.splash_bwd_dq_plain(*band)}
    pos = torch.arange(t, device=q3.device)
    mask = pos[None, :] <= pos[:, None]
    if window:
        mask &= pos[None, :] > pos[:, None] - window
    worst = dict.fromkeys(runs, 0.0)
    worst_dq = dict.fromkeys(dq_runs, 0.0)
    for g in range(bkh):
        rows = slice(g * n_rep, (g + 1) * n_rep)
        qq, dd = q3[rows].double(), do3[rows].double()
        s = torch.einsum("rtd,sd->rts", qq, k3[g].double()) / d ** 0.5
        p = torch.exp(s - lse[rows].double()[..., None]).masked_fill_(~mask, 0.0)
        del s
        dp = torch.einsum("rtd,sd->rts", dd, v3[g].double())
        ds = p * (dp - delta[rows].double()[..., None]) / d ** 0.5
        del dp
        exact = (torch.einsum("rts,rtd->sd", ds, qq), torch.einsum("rts,rtd->sd", p, dd))
        exact_dq = torch.einsum("rts,sd->rtd", ds, k3[g].double())
        del p, ds
        for run, got in runs.items():
            err = max(float((x[g].double() - e).abs().max()) for x, e in zip(got, exact))
            worst[run] = max(worst[run], err)
        for run, got in dq_runs.items():
            worst_dq[run] = max(worst_dq[run], float((got[rows].double() - exact_dq).abs().max()))
        del exact, exact_dq
    for name, found, heads in ((names[0], worst_dq, f"{bkh * n_rep} heads"),
                               (names[1], worst, f"{bkh} KV heads")):
        for run, err in found.items():
            if not err <= FLASH_TOL:
                raise AssertionError(f"{name} {label}: the {run} lies {err:.3e} from fp64"
                                     f" sums, beyond atol {FLASH_TOL:g}")
        log(f"kernel {name} {label}: max |x - fp64| over the {heads}: "
            + ", ".join(f"{run} {err:.3e}" for run, err in found.items())
            + f" (atol {FLASH_TOL:g}) ok")
    if window is not None or pairs is not None:
        del runs, dq_runs
        torch.cuda.empty_cache()
        return

    q, do = flash._grouped(q3, bkh), flash._grouped(do3, bkh)
    blocks = [(s0, s1, p, ds, q[:, :, r0:], do[:, :, r0:])
              for s0, s1, r0, p, ds, _ in flash._bwd_blocks(*args, True)]
    forms = {"batched over the KV heads": lambda a, b: torch.einsum("grts,grtd->gsd", a, b),
             "one KV head at a time": lambda a, b: [torch.einsum("rts,rtd->sd", x, y)
                                                    for x, y in zip(a, b)]}
    plain_dk, plain_dv = runs["plain version"]
    for form, gemm in forms.items():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            sums = [(gemm(ds, qb), gemm(p, dob)) for _, _, p, ds, qb, dob in blocks]
            torch.cuda.synchronize()
        drift = 0.0
        for (s0, s1, *_), (dk, dv) in zip(blocks, sums):
            for got, want in ((dk, plain_dk), (dv, plain_dv)):
                drift = max(drift, max(float((x - w[s0:s1]).abs().max())
                                       for x, w in zip(got, want)))
        kernels = sorted(f"{e.key[:120]} x{e.count}" for e in prof.key_averages()
                         if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0)
        log(f"fp32 sums of the plain version's p and ds {label}, {form}: max |fp32 - fp64"
            f" sums| {drift:.3e} (not held to the limit); device kernels: {'; '.join(kernels)}")
    del runs, dq_runs, blocks, forms
    torch.cuda.empty_cache()


def flash_planted_faults(label, q3, k3, v3, do3,
                         tiles=(FLASH_TILE, FLASH_DQ_KV_TILE, FLASH_DKV_Q_TILE)) -> None:
    """What a kernel that skipped one tile would read against the plain
    version, computed by the plain versions: the forward and dq without
    their last KV tile, dk/dv without the last q tile (its do and delta rows
    set to 0, which removes exactly that tile's terms). Under causal masking
    the last rows spread their softmax over the most keys, so these tiles
    carry the smallest weights and their loss is the hardest to see. Each
    reading must lie far outside FLASH_TOL. ``tiles``: the forward's and
    dq's KV tile and dk/dv's q tile."""
    import torch

    from dstack_tpu_torch.workloads.kernels import flash

    fwd_tile, dq_tile, dkv_tile = tiles
    keep = k3.shape[1] - fwd_tile
    keep_dq = k3.shape[1] - dq_tile
    ro, rlse = flash.flash_fwd_plain(q3, k3, v3, True)
    delta = (do3 * ro).sum(-1)
    fo, flse = flash.flash_fwd_plain(q3, k3[:, :keep], v3[:, :keep], True)
    dq = flash.flash_bwd_dq_plain(q3, k3, v3, do3, rlse, delta, True)
    fdq = flash.flash_bwd_dq_plain(q3, k3[:, :keep_dq], v3[:, :keep_dq], do3, rlse, delta, True)
    cut_do, cut_delta = do3.clone(), delta.clone()
    cut_do[:, -dkv_tile:] = 0
    cut_delta[:, -dkv_tile:] = 0
    dkv = flash.flash_bwd_dkv_plain(q3, k3, v3, do3, rlse, delta, True)
    fdkv = flash.flash_bwd_dkv_plain(q3, k3, v3, cut_do, rlse, cut_delta, True)
    readings = {
        "flash_fwd": ("last KV tile", fwd_tile, (fo, flse), (ro, rlse)),
        "flash_bwd_dq": ("last KV tile", dq_tile, (fdq,), (dq,)),
        "flash_bwd_dkv": ("last q tile", dkv_tile, fdkv, dkv),
    }
    for name, (tile, rows, fault, ref) in readings.items():
        err = max(float((f - r).abs().max()) for f, r in zip(fault, ref))
        if not err > 10 * FLASH_TOL:
            raise AssertionError(
                f"{name}: a dropped {tile} reads {err:.3e}, within 10x of atol {FLASH_TOL:g}"
            )
        log(f"planted fault {name} {label} ({tile} of {rows} rows dropped): max |fault -"
            f" plain| {err:.3e} = {err / FLASH_TOL:.0f}x atol {FLASH_TOL:g}; the check fails it")
    del ro, rlse, fo, flse, dq, fdq, dkv, fdkv
    torch.cuda.empty_cache()


def flash_bounds(b, h, kh, d, t, item, pairs=None, doc_bytes=0, names=None) -> dict:
    """(bound_ms, bound_by) per flash kernel for causal T = S = t: each input
    read once and each output written once against 3.35 TB/s; the products
    the live (query, key) pairs need (default t(t+1)/2 for each head; fwd:
    QK and PV; dq: QK, dO V, dS K; dk/dv: QK, dO V, P^T dO, dS^T Q) at the
    peak of the inputs' type. ``doc_bytes`` adds document planes read once;
    ``names`` renames the three kernels (splash)."""
    if pairs is None:
        pairs = b * h * t * (t + 1) / 2
    q_bytes, kv_bytes = b * h * t * d * item, 2 * b * kh * t * d * item + doc_bytes
    f32_rows, f32_q = b * h * t * 4, b * h * t * d * 4
    work = {
        "flash_fwd": (4 * d * pairs, q_bytes + kv_bytes + f32_q + f32_rows),
        "flash_bwd_dq": (6 * d * pairs, q_bytes + kv_bytes + 2 * f32_q + 2 * f32_rows),
        "flash_bwd_dkv": (8 * d * pairs, q_bytes + kv_bytes + f32_q + 2 * f32_rows
                          + 2 * b * kh * t * d * 4),
    }
    peak = BF16_FLOP_PER_S if item == 2 else FP32_FLOP_PER_S
    out = {}
    for i, (name, (flops, nbytes)) in enumerate(work.items()):
        t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
        out[names[i] if names else name] = (
            float(max(t_ops, t_bytes) * 1e3), "operations" if t_ops >= t_bytes else "bytes")
    return out


def phase_flash() -> dict:
    import torch

    from dstack_tpu_torch.workloads.kernels import flash

    log_instantiations(flash, flash.launches, set(flash.launches))
    report = {}
    for i, (label, b, h, kh, d, t) in enumerate(FLASH_GEOMETRIES):
        x = flash_inputs(b, h, kh, d, t, torch.bfloat16, seed=10 + i)
        errs = flash_compare(label, *x, causal=True)
        if i == 0:
            # dq and dk/dv as training feeds them: do holds bf16 values (the
            # model casts o to bf16), so the kernels skip do's zero low planes.
            q3, k3, v3, do3 = x
            errs_bf16_do = flash_compare(f"{label} (do of bf16 values)", q3, k3, v3,
                                         do3.bfloat16().float(), causal=True)
            errs = {n: max(e, errs_bf16_do[n]) for n, e in errs.items()}
            for do_label, d_o in (("fp32 do", do3), ("do of bf16 values", do3.bfloat16().float())):
                flash_bwd_against_fp64(f"{label}, {do_label}", q3, k3, v3, d_o)
        for name, err in errs.items():
            entry = report.setdefault(name, {"max_abs_err": 0.0})
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
        if i == 0:
            flash_planted_faults(label, *x)
            report["timing"] = flash_timing(label, b, h, kh, d, t, *x)
        del x
        torch.cuda.empty_cache()
    # fp32 and D 96 run the CUDA-core kernels.
    for label, t, d, dtype, causal in (("T=1024", 1024, 128, torch.float32, True),
                                       ("ragged T=72", 72, 128, torch.bfloat16, True),
                                       ("ragged T=72", 72, 128, torch.float32, True),
                                       ("T=1024", 1024, 128, torch.bfloat16, False),
                                       ("D=96, T=1024", 1024, 96, torch.bfloat16, True)):
        flash_compare(f"llama3_1b heads, {label}", *flash_inputs(2, 16, 8, d, t, dtype, 20),
                      causal=causal)
    timing = report.pop("timing")
    for name, entry in report.items():
        entry.update(timing[name])
    return report


def flash_timing(label, b, h, kh, d, t, q3, k3, v3, do3) -> dict:
    """CUDA-event medians of each kernel, its plain version and the SDPA
    yardstick (its forward for the fwd kernel; its backward, dq, dk and dv
    together, for both backward kernels), with the bounds."""
    import torch

    from dstack_tpu_torch.workloads.kernels import flash

    o, lse = flash.flash_fwd(q3, k3, v3, True)
    delta = (do3 * o).sum(-1)
    pairs = {
        "flash_fwd": (lambda: flash.flash_fwd(q3, k3, v3, True),
                      lambda: flash.flash_fwd_plain(q3, k3, v3, True)),
        "flash_bwd_dq": (lambda: flash.flash_bwd_dq(q3, k3, v3, do3, lse, delta, True),
                         lambda: flash.flash_bwd_dq_plain(q3, k3, v3, do3, lse, delta, True)),
        "flash_bwd_dkv": (lambda: flash.flash_bwd_dkv(q3, k3, v3, do3, lse, delta, True),
                          lambda: flash.flash_bwd_dkv_plain(q3, k3, v3, do3, lse, delta, True)),
    }
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4 = q3.reshape(b, h, t, d).detach().requires_grad_(True)
    k4 = k3.reshape(b, kh, t, d).detach().requires_grad_(True)
    v4 = v3.reshape(b, kh, t, d).detach().requires_grad_(True)
    out4 = sdpa(q4, k4, v4, is_causal=True, enable_gqa=True)
    do4 = do3.reshape(b, h, t, d).to(out4.dtype)
    library_fwd = time_ms(lambda: sdpa(q4, k4, v4, is_causal=True, enable_gqa=True))
    library_bwd = time_ms(
        lambda: torch.autograd.grad(out4, (q4, k4, v4), do4, retain_graph=True)
    )
    bounds = flash_bounds(b, h, kh, d, t, q3.element_size())
    out = {}
    for name, (kernel, plain) in pairs.items():
        entry = {"ms": time_ms(kernel), "plain_ms": time_ms(plain),
                 "library_ms": library_fwd if name == "flash_fwd" else library_bwd}
        entry["bound_ms"], entry["bound_by"] = bounds[name]
        out[name] = entry
        log(f"kernel {name} {label} bf16 timing: {entry['ms']:.4f} ms, plain"
            f" {entry['plain_ms']:.4f} ms, sdpa {'fwd' if name == 'flash_fwd' else 'bwd'}"
            f" {entry['library_ms']:.4f} ms, bound {entry['bound_ms']:.4f} ms"
            f" ({entry['bound_by']})")
    do_bf16 = do3.bfloat16().float()
    for name, kernel in (("flash_bwd_dq", flash.flash_bwd_dq), ("flash_bwd_dkv", flash.flash_bwd_dkv)):
        ms = time_ms(lambda: kernel(q3, k3, v3, do_bf16, lse, delta, True))
        log(f"kernel {name} {label} bf16 timing with a do of bf16 values (training's"
            f" inputs): {ms:.4f} ms")
    return out


# -- phase 3b: splash kernels ---------------------------------------------------

# llama3_1b heads (B 2, H 16, Kh 8, D 128) at T = S = 8192, bf16: the windows
# compared and timed; the first (the training example's) is the kernels line's.
SPLASH_GEOMETRY = (2, 16, 8, 128, 8192)
SPLASH_WINDOWS = (4096, 0, 1024)
# The handoff's distillation runs the target's forward at B 2, T 2048 under
# window 4096 (wider than T, so causal).
DISTILL_SHAPE_LABEL = "T=2048, window wider than T (the distillation's target)"
# Four packed documents of uneven length in each 8192-token row.
SPLASH_DOCS = (3000, 1500, 2692, 1000)
# Tolerance of every splash comparison, as flash's: the kernels keep every
# product exact in fp32 (split bf16 terms on the tensor cores, fp32 FMAs on
# the CUDA cores) and differ from the plain versions (whose dk/dv sums are
# fp64) in the order and rounding of the sums.
SPLASH_TOL = FLASH_TOL
# Each kernel's (row, key) tile edges at bf16 D 128: the tensor-core forward
# walks 64-row q tiles over 64-key tiles, the tensor-core dq 64-row q tiles
# over 32-key tiles, the tensor-core dk/dv 64-key tiles over 32-row q tiles.
# The planted band faults drop one tile pair at these edges.
SPLASH_TILES = {"splash_fwd": (64, 64), "splash_bwd_dq": (64, 32), "splash_bwd_dkv": (32, 64)}


def doc_plane(lengths, b):
    """[b, sum(lengths)] int32 on the card: document i covers lengths[i]
    positions of every row."""
    import torch

    row = np.concatenate([np.full(n, i, np.int32) for i, n in enumerate(lengths)])
    return torch.from_numpy(np.stack([row] * b)).cuda()


def live_pairs(b, h, t, causal, window, lengths=None) -> float:
    """(query, key) pairs the splash mask leaves live over B*H heads, for
    these inputs (T = S = t)."""
    qp = np.arange(t, dtype=np.int64)
    start = np.zeros(t, np.int64)
    if lengths:
        start = np.repeat(np.cumsum((0,) + tuple(lengths))[:-1], lengths)
    lo = np.maximum(start, qp - window + 1) if window else start
    if causal:
        per_row = qp - lo + 1
    else:
        end = np.repeat(np.cumsum(lengths), lengths) if lengths else np.full(t, t)
        per_row = end - lo
    return float(b * h * per_row.sum())


def splash_run(q3, k3, v3, do3, docs, causal, window, plain: bool) -> list:
    """[o, lse, dq, dk, dv] of the kernels (plain=False) or their plain
    versions, the backward on the plain forward's lse and delta."""
    from dstack_tpu_torch.workloads.kernels import splash

    ro, rlse = splash.splash_fwd_plain(q3, k3, v3, docs, docs, causal, window)
    args = (q3, k3, v3, do3, rlse, (do3 * ro).sum(-1), docs, docs, causal, window)
    if plain:
        return [ro, rlse, splash.splash_bwd_dq_plain(*args), *splash.splash_bwd_dkv_plain(*args)]
    o, lse = splash.splash_fwd(q3, k3, v3, docs, docs, causal, window)
    return [o, lse, splash.splash_bwd_dq(*args), *splash.splash_bwd_dkv(*args)]


def splash_compare(label, q3, k3, v3, do3, docs, causal, window) -> dict:
    """Each splash kernel against its plain version on the same inputs;
    max |error| per kernel."""
    import torch

    got = splash_run(q3, k3, v3, do3, docs, causal, window, plain=False)
    torch.cuda.synchronize()
    ref = splash_run(q3, k3, v3, do3, docs, causal, window, plain=True)
    errs = {}
    for name, idx in (("splash_fwd", (0, 1)), ("splash_bwd_dq", (2,)), ("splash_bwd_dkv", (3, 4))):
        errs[name] = 0.0
        for i in idx:
            if not bool(torch.isfinite(got[i]).all()):
                raise AssertionError(f"{name} {label}: non-finite output")
            torch.testing.assert_close(got[i], ref[i], atol=SPLASH_TOL, rtol=0)
            errs[name] = max(errs[name], float((got[i] - ref[i]).abs().max()))
        log(f"kernel {name} {label} {str(q3.dtype)[6:]} causal={causal} window={window}"
            f" docs={'yes' if docs is not None else 'no'}: max_abs_err {errs[name]:.3e}"
            f" (max |ref| {max(float(ref[i].abs().max()) for i in idx):.3g};"
            f" atol {SPLASH_TOL:g}) ok")
    return errs


class planted_band_fault:
    """While active, the plain versions' element mask also drops one tile
    pair per tile of the band, as a kernel with an off-by-one in its loop
    bounds would: ``drop(row_tile, key_tile)`` is True where a pair is
    dropped, rows in tiles of ``rows`` and keys in tiles of ``keys``."""

    def __init__(self, drop, rows, keys):
        self.drop, self.rows, self.keys = drop, rows, keys

    def __enter__(self):
        import torch

        from dstack_tpu_torch.workloads.kernels import splash

        self.inner = inner = splash._block_mask
        drop, row_tile, key_tile = self.drop, self.rows, self.keys

        def mask(r0, r1, s0, s1, causal, window, docq, dock, device):
            m = inner(r0, r1, s0, s1, causal, window, docq, dock, device)
            rows = torch.arange(r0, r1, device=device)[:, None] // row_tile
            keys = torch.arange(s0, s1, device=device)[None, :] // key_tile
            keep = ~drop(rows, keys)
            return keep if m is None else m & keep

        splash._block_mask = mask
        return self

    def __exit__(self, *exc):
        from dstack_tpu_torch.workloads.kernels import splash

        splash._block_mask = self.inner


def band_faults(t, window, rows, keys):
    """{edge: (drop for the forward and dq walks, drop for the dk/dv walk)}
    at (rows, keys) tile edges. Forward and dq: the first live KV tile of
    each q tile's band is the window's near edge, the last the causal
    diagonal; faults go only where a band holds more than one tile (q tile
    0's only tile empties row 0, a reading of 1e30 that says nothing about
    the limit). dk/dv: each KV tile's first live q tile is the diagonal, the
    last the window's far edge."""
    import torch

    n_kv, n_q = -(-t // keys), -(-t // rows)
    first_kv = lambda iq: torch.clamp(iq * rows - (window - 1), min=0) // keys
    last_kv = lambda iq: torch.clamp((torch.clamp((iq + 1) * rows, max=t) - 1) // keys,
                                     max=n_kv - 1)
    wide = lambda iq: first_kv(iq) < last_kv(iq)
    first_q = lambda jk: (jk * keys) // rows
    last_q = lambda jk: torch.clamp(
        (torch.clamp((jk + 1) * keys, max=t) - 1 + window - 1) // rows, max=n_q - 1)
    return {
        "first": (lambda r, c: wide(r) & (c == first_kv(r)), lambda r, c: r == first_q(c)),
        "last": (lambda r, c: wide(r) & (c == last_kv(r)), lambda r, c: r == last_q(c)),
    }


def splash_planted_faults(label, q3, k3, v3, do3, window, tiles=SPLASH_TILES) -> None:
    """What kernels with an off-by-one at the band's edges would read
    against the plain versions, computed by the plain versions at each
    kernel's own tile edges (SPLASH_TILES): the forward and dq dropping each
    q tile's first live KV tile (lo) or its last (hi - 1), dk/dv dropping
    each KV tile's first or last live q tile. Each reading must lie far
    outside SPLASH_TOL."""
    import torch

    from dstack_tpu_torch.workloads.kernels import splash

    t = q3.shape[1]
    ro, rlse = splash.splash_fwd_plain(q3, k3, v3, None, None, True, window)
    args = (q3, k3, v3, do3, rlse, (do3 * ro).sum(-1), None, None, True, window)
    ref = {"splash_fwd": (ro, rlse), "splash_bwd_dq": (splash.splash_bwd_dq_plain(*args),),
           "splash_bwd_dkv": splash.splash_bwd_dkv_plain(*args)}
    run = {"splash_fwd": lambda: splash.splash_fwd_plain(q3, k3, v3, None, None, True, window),
           "splash_bwd_dq": lambda: (splash.splash_bwd_dq_plain(*args),),
           "splash_bwd_dkv": lambda: splash.splash_bwd_dkv_plain(*args)}
    for name, (rows, keys) in tiles.items():
        tile = "live q tile" if name == "splash_bwd_dkv" else "live KV tile"
        for edge, (kv_drop, q_drop) in band_faults(t, window, rows, keys).items():
            # Each faulty kernel reads the right residuals (lse, delta) and
            # drops its own tile pairs.
            with planted_band_fault(q_drop if name == "splash_bwd_dkv" else kv_drop, rows, keys):
                got = run[name]()
            err = max(float((f - r).abs().max()) for f, r in zip(got, ref[name]))
            if not err > 10 * SPLASH_TOL:
                raise AssertionError(
                    f"{name}: dropping the band's {edge} {tile} reads {err:.3e}, within 10x of"
                    f" atol {SPLASH_TOL:g}")
            log(f"planted fault {name} {label} window={window} (the band's {edge} {tile} of a"
                f" {rows}-row x {keys}-key tile pair dropped): max |fault - plain| {err:.3e} ="
                f" {err / SPLASH_TOL:.0f}x atol {SPLASH_TOL:g}; the check fails it")
            del got
    del ref
    torch.cuda.empty_cache()


def splash_matches_flash(q3, k3, v3, do3) -> None:
    """Splash without a window or documents is flash attention: the splash
    kernels against the flash kernels on the same inputs."""
    import torch

    from dstack_tpu_torch.workloads.kernels import flash

    got = splash_run(q3, k3, v3, do3, None, True, 0, plain=False)
    o, lse = flash.flash_fwd(q3, k3, v3, True)
    ro, rlse = flash.flash_fwd_plain(q3, k3, v3, True)
    args = (q3, k3, v3, do3, rlse, (do3 * ro).sum(-1), True)
    want = [o, lse, flash.flash_bwd_dq(*args), *flash.flash_bwd_dkv(*args)]
    err = 0.0
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=SPLASH_TOL, rtol=0)
        err = max(err, float((g - w).abs().max()))
    log(f"splash window=0 == flash kernels (o, lse, dq, dk, dv): max |splash - flash| {err:.3e}"
        f" (atol {SPLASH_TOL:g}) ok")


def splash_timing(q3, k3, v3, do3, window) -> dict:
    """CUDA-event medians of each splash kernel and its plain version at
    this window, the SDPA yardstick under the same boolean band mask (its
    forward for the fwd kernel; its backward, dq, dk and dv together, for
    both backward kernels; forward+backward printed beside), and the bounds
    from this window's live pairs."""
    import torch

    from dstack_tpu_torch.workloads.kernels import splash

    b, h, kh, d, t = SPLASH_GEOMETRY
    o, lse = splash.splash_fwd(q3, k3, v3, None, None, True, window)
    args = (q3, k3, v3, do3, lse, (do3 * o).sum(-1), None, None, True, window)
    pairs = {
        "splash_fwd": (lambda: splash.splash_fwd(q3, k3, v3, None, None, True, window),
                       lambda: splash.splash_fwd_plain(q3, k3, v3, None, None, True, window)),
        "splash_bwd_dq": (lambda: splash.splash_bwd_dq(*args),
                          lambda: splash.splash_bwd_dq_plain(*args)),
        "splash_bwd_dkv": (lambda: splash.splash_bwd_dkv(*args),
                           lambda: splash.splash_bwd_dkv_plain(*args)),
    }
    sdpa = torch.nn.functional.scaled_dot_product_attention
    pos = torch.arange(t, device="cuda")
    band = pos[None, :] <= pos[:, None]
    if window:
        band &= pos[None, :] > pos[:, None] - window
    q4 = q3.reshape(b, h, t, d).detach().requires_grad_(True)
    k4 = k3.reshape(b, kh, t, d).detach().requires_grad_(True)
    v4 = v3.reshape(b, kh, t, d).detach().requires_grad_(True)
    call = lambda: sdpa(q4, k4, v4, attn_mask=band, enable_gqa=True)  # noqa: E731
    out4 = call()
    do4 = do3.reshape(b, h, t, d).to(out4.dtype)
    library_fwd = time_ms(call, iters=10)
    library_bwd = time_ms(lambda: torch.autograd.grad(out4, (q4, k4, v4), do4, retain_graph=True),
                          iters=10)
    library_both = time_ms(lambda: torch.autograd.grad(call(), (q4, k4, v4), do4), iters=10)
    del out4
    live = live_pairs(b, h, t, True, window)
    bounds = flash_bounds(b, h, kh, d, t, q3.element_size(), pairs=live,
                          names=list(pairs))
    log(f"splash window={window}: {live / (b * h):.0f} live (query, key) pairs per head"
        f" ({100 * live / (b * h * t * (t + 1) / 2):.1f}% of causal); yardstick"
        f" scaled_dot_product_attention(attn_mask=[T, T] bool band, enable_gqa=True):"
        f" fwd {library_fwd:.4f} ms, bwd {library_bwd:.4f} ms, fwd+bwd {library_both:.4f} ms")
    out = {}
    for name, (kernel, plain) in pairs.items():
        entry = {"ms": time_ms(kernel, iters=10), "plain_ms": time_ms(plain, iters=10),
                 "library_ms": library_fwd if name == "splash_fwd" else library_bwd}
        entry["bound_ms"], entry["bound_by"] = bounds[name]
        out[name] = entry
        log(f"kernel {name} window={window} bf16 timing: {entry['ms']:.4f} ms, plain"
            f" {entry['plain_ms']:.4f} ms, sdpa {'fwd' if name == 'splash_fwd' else 'bwd'}"
            f" {entry['library_ms']:.4f} ms, bound {entry['bound_ms']:.4f} ms"
            f" ({entry['bound_by']}); {entry['ms'] / entry['bound_ms']:.1f}x the bound")
    # dq and dk/dv as training feeds them: do holds bf16 values, so the
    # tensor-core kernels skip do's zero low planes.
    bf16_args = (q3, k3, v3, do3.bfloat16().float(), *args[4:])
    for name, kernel in (("splash_bwd_dq", splash.splash_bwd_dq),
                         ("splash_bwd_dkv", splash.splash_bwd_dkv)):
        ms = time_ms(lambda: kernel(*bf16_args), iters=10)
        log(f"kernel {name} window={window} bf16 timing with a do of bf16 values"
            f" (training's inputs): {ms:.4f} ms")
    return out


def phase_splash() -> dict:
    """What each splash wrapper runs (all three on tensor cores exactly at
    bf16 D 128), the splash kernels against their plain
    versions at llama3_1b heads (T 8192 bf16 at windows 4096, 0 and 1024, and
    4096 with documents; fp32 at T 1024; a ragged T 72; causal=False with
    documents; D 96 with documents), dq and dk/dv against fp64 sums at
    window 4096, the planted
    band faults at each kernel's own tiles, splash W 0 against the flash
    kernels, the times per window, and the skipping: the W 1024 forward and
    dq each under 0.4x their W 0 time."""
    import torch

    from dstack_tpu_torch.workloads.kernels import flash, splash

    log_instantiations(splash, splash.launches, set(splash.launches))
    b, h, kh, d, t = SPLASH_GEOMETRY
    report = {name: {"max_abs_err": 0.0} for name in ("splash_fwd", "splash_bwd_dq",
                                                      "splash_bwd_dkv")}

    def keep(errs):
        for name, err in errs.items():
            report[name]["max_abs_err"] = max(report[name]["max_abs_err"], err)

    x = flash_inputs(b, h, kh, d, t, torch.bfloat16, seed=30)
    docs = doc_plane(SPLASH_DOCS, b)
    for window in SPLASH_WINDOWS:
        keep(splash_compare("llama3_1b heads, T=8192", *x, None, True, window))
    keep(splash_compare(f"llama3_1b heads, T=8192, docs {SPLASH_DOCS}", *x, docs, True, 4096))
    q3, k3, v3, do3 = x
    for do_label, d_o in (("fp32 do", do3), ("do of bf16 values", do3.bfloat16().float())):
        flash_bwd_against_fp64(f"llama3_1b heads, T=8192, window={SPLASH_WINDOWS[0]}, {do_label}",
                               q3, k3, v3, d_o, window=SPLASH_WINDOWS[0])
    splash_planted_faults("llama3_1b heads, T=8192", *x, SPLASH_WINDOWS[0])
    splash_matches_flash(*x)
    timing = {window: splash_timing(*x, window) for window in SPLASH_WINDOWS}
    # Window 0 is flash attention: dq beside flash's on the same inputs.
    o, lse = flash.flash_fwd(q3, k3, v3, True)
    flash_ms = time_ms(lambda: flash.flash_bwd_dq(q3, k3, v3, do3, lse, (do3 * o).sum(-1), True),
                       iters=10)
    del o, lse
    w0 = timing[0]["splash_bwd_dq"]["ms"]
    log(f"splash_bwd_dq window=0 {w0:.4f} ms / flash_bwd_dq {flash_ms:.4f} ms on the same"
        f" inputs = {w0 / flash_ms:.3f}")
    for name in ("splash_fwd", "splash_bwd_dq"):
        w1024, w0 = timing[1024][name]["ms"], timing[0][name]["ms"]
        log(f"splash skipping: {name} window=1024 {w1024:.4f} ms / window=0 {w0:.4f} ms ="
            f" {w1024 / w0:.3f} (must be < 0.4)")
        if not w1024 / w0 < 0.4:
            raise AssertionError(f"{name} at window=1024 takes {w1024 / w0:.3f}x its window=0 time")
    del x, docs
    torch.cuda.empty_cache()
    # fp32 and D 96 run the CUDA-core kernels; the last case is the shape
    # the handoff's distillation gives the forward kernel.
    for label, t_len, d_head, dtype, causal, window, lengths in (
        ("T=1024", 1024, d, torch.float32, True, 256, None),
        ("ragged T=72", 72, d, torch.bfloat16, True, 40, None),
        ("ragged T=72", 72, d, torch.float32, True, 40, None),
        ("T=1024, docs (300, 700, 24)", 1024, d, torch.bfloat16, False, 0, (300, 700, 24)),
        ("D=96, T=1024, docs (300, 700, 24)", 1024, 96, torch.bfloat16, True, 256,
         (300, 700, 24)),
        (DISTILL_SHAPE_LABEL, 2048, d, torch.bfloat16, True, 4096, None),
    ):
        x = flash_inputs(b, h, kh, d_head, t_len, dtype, 31)
        docs = doc_plane(lengths, b) if lengths else None
        errs = splash_compare(f"llama3_1b heads, {label}", *x, docs, causal, window)
        keep(errs)
        if label == DISTILL_SHAPE_LABEL:
            report["splash_fwd"]["distill_max_abs_err"] = errs["splash_fwd"]
    for name, entry in report.items():
        entry.update(timing[SPLASH_WINDOWS[0]][name])
    return report


# -- phase 4: the serving path -----------------------------------------------


class _StepErrors(logging.Handler):
    """Collects the engine runner's logged step failures, so a failed step
    fails the drive at once instead of leaving requests unfinished."""

    def __init__(self):
        super().__init__(level=logging.ERROR)
        self.records = []

    def emit(self, record):
        self.records.append(self.format(record))


def count_calls(engine, attr: str) -> list:
    """Wrap engine.<attr> (a step function) to count its calls."""
    calls = [0]
    inner = getattr(engine, attr)

    def counted(*args, **kwargs):
        calls[0] += 1
        return inner(*args, **kwargs)

    setattr(engine, attr, counted)
    return calls


def drive_runner(engine, waves, max_new: int, timeout: float = 600.0) -> dict:
    """Submit every prompt through EngineRunner.submit and wait for all. The
    prompts come in waves: a wave is submitted once every request of the one
    before it has its first token (its prompt is prefilled, and with the
    prefix cache registered)."""
    from dstack_tpu_torch.workloads import serve

    errors = _StepErrors()
    serve.logger.addHandler(errors)
    runner = serve.EngineRunner(engine)
    prompts = [p for wave in waves for p in wave]
    tokens = [[] for _ in prompts]
    first = threading.Semaphore(0)
    finished = threading.Semaphore(0)

    def on_event(i):
        def cb(ev):
            tokens[i].append(ev.token)
            if ev.index == 0:
                first.release()
            if ev.done:
                finished.release()
        return cb

    def wait(sem, n, what):
        for _ in range(n):
            while not sem.acquire(timeout=0.5):
                if errors.records:
                    raise RuntimeError("engine step failed:\n" + errors.records[0])
                if time.monotonic() - t0 > timeout:
                    raise TimeoutError(f"requests did not {what}")

    t0 = time.monotonic()
    runner.start()
    try:
        i = 0
        for w, wave in enumerate(waves):
            if w:
                wait(first, len(waves[w - 1]), "reach their first token")
            for p in wave:
                runner.submit(p, max_new, on_event(i))
                i += 1
        wait(finished, len(prompts), "finish")
        wall = time.monotonic() - t0
    finally:
        runner.shutdown()
        runner.join(timeout=60)
        serve.logger.removeHandler(errors)
    if runner.is_alive():
        raise RuntimeError("engine runner did not stop")
    return {"tokens": tokens, "wall_s": wall}


def phase_serve(card: str) -> dict:
    import torch

    from dstack_tpu_torch.workloads import model, serve
    from dstack_tpu_torch.workloads.config import get_config
    from dstack_tpu_torch.workloads.kernels import paged

    cfg = get_config("llama3_8b")
    t0 = time.monotonic()
    params = model.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), torch.device("cuda"),
        dtype=torch.bfloat16,
    )
    torch.cuda.synchronize()
    log(f"serve: llama3_8b bf16 weights initialised in {time.monotonic() - t0:.1f} s"
        f" ({sum(p.numel() for p in params.values()) / 1e9:.2f} B params)")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist() for n in BURST_LENGTHS]
    max_new = 32
    launches = {}
    for chunk in (0, 512):
        engine = serve.ServeEngine(
            cfg,
            serve.EngineConfig(max_batch=16, num_pages=4096, page_size=16, prefill_chunk=chunk),
            params=params,
        )
        if engine.decode_impl != "cuda":
            raise AssertionError(f"engine decode_impl is {engine.decode_impl}")
        decode_calls = count_calls(engine, "_decode_fn")
        chunk_calls = count_calls(engine, "_chunk_fn") if chunk else [0]
        torch.cuda.synchronize()
        paged.reset_launches()
        out = drive_runner(engine, [prompts], max_new)
        got = dict(paged.launches)
        for p, toks in zip(prompts, out["tokens"]):
            if len(toks) != max_new or not all(0 <= t < cfg.vocab_size for t in toks):
                raise AssertionError(f"request of {len(p)} tokens returned {toks}")
        if got["paged_decode_attention"] != cfg.n_layers * decode_calls[0]:
            raise AssertionError(
                f"decode kernel launches {got['paged_decode_attention']} !="
                f" {cfg.n_layers} layers x {decode_calls[0]} decode steps"
            )
        if got["paged_chunk_attention"] != cfg.n_layers * chunk_calls[0]:
            raise AssertionError(
                f"chunk kernel launches {got['paged_chunk_attention']} !="
                f" {cfg.n_layers} layers x {chunk_calls[0]} chunk steps"
            )
        if chunk and got["paged_chunk_attention"] == 0:
            raise AssertionError("prefill_chunk=512 never launched the chunk kernel")
        for name, n in got.items():
            launches[name] = launches.get(name, 0) + n
        lat = engine.flight.latency_summary()
        n_tok = sum(len(t) for t in out["tokens"])
        log(f"serve prefill_chunk={chunk}: 16 requests x {max_new} tokens in"
            f" {out['wall_s']:.2f} s, {n_tok / out['wall_s']:.1f} tokens/s, TTFT p50"
            f" {lat['ttft_p50_ms']} ms, ITL p50 {lat['itl_p50_ms']} ms;"
            f" decode steps {decode_calls[0]}, chunk steps {chunk_calls[0]},"
            f" launches {got} [{card}]")
        del engine
        torch.cuda.empty_cache()
    profile_steps(cfg, params, prompts, card)
    weight_only_on_card(cfg, card)
    for name, n in serve_example_flags(cfg, params, card).items():
        launches[name] += n
    del params
    torch.cuda.empty_cache()
    return launches


def tree_bytes(params: dict) -> int:
    return sum(t.numel() * t.element_size() for t in params.values())


def step_ms(cfg, params, quant: str, spec_tokens: int, card: str, steps: int = 8) -> float:
    """Median wall time of one engine step with 16 slots decoding (prompts of
    128 tokens, budgets that keep every verify row valid): a plain decode
    step, or with spec_tokens a verify step. Each step ends by copying its
    tokens to the host, which waits for the card. Then torch.profiler over
    one more step: where its time goes."""
    from dstack_tpu_torch.workloads import serve

    engine = serve.ServeEngine(
        cfg,
        serve.EngineConfig(max_batch=16, num_pages=1024, page_size=16, quant=quant,
                           spec_tokens=spec_tokens),
        params=params,
    )
    rng = np.random.RandomState(3)
    for _ in range(16):
        engine.submit(rng.randint(0, cfg.vocab_size, 128).tolist(), max_new_tokens=128)
    engine.step()  # admission, prefill and the first decode step
    times = []
    for _ in range(steps):
        t0 = time.monotonic()
        engine.step()
        times.append((time.monotonic() - t0) * 1e3)
    kind = "verify" if spec_tokens else "decode"
    profile_window(f"{'bf16' if quant == 'none' else quant} {kind} step (16 slots)", engine.step,
                   card, share_of="paged_chunk_mma_kernel" if spec_tokens else "paged_decode_")
    if engine.active_count != 16:
        raise AssertionError(f"{engine.active_count} slots decoding, not 16")
    del engine
    return float(np.median(times))


# weight_only_matmul on the card against fp64 sums, as a share of the largest
# |product|: an fp32-accumulated product scaled before one cast sits near fp32
# rounding; the planted fault (the bf16 product rounded before the scale, two
# roundings where the JAX package has one) must read above the limit.
WEIGHT_ONLY_LIMIT = 1e-4


def weight_only_on_card(cfg, card: str) -> None:
    """The serve path's quantized projections on the card: quantize_fp8 and
    quantize_int8 give the same bits and scales on the card as on the CPU,
    and weight_only_matmul's card branch (bf16 x, torch.mm with an fp32
    output) agrees with fp64 sums of the same values and scales, at
    llama3_8b's wq, w_gate, w_down and lm_head shapes, on a 3-D x of the
    verify step's [16 slots, spec_tokens + 1 rows, K]."""
    import torch

    from dstack_tpu_torch.workloads import quantize

    gen = torch.Generator(device="cuda").manual_seed(5)
    shapes = {"wq": (cfg.d_model, cfg.n_heads * cfg.head_dim),
              "w_gate": (cfg.d_model, cfg.d_ff), "w_down": (cfg.d_ff, cfg.d_model),
              "lm_head": (cfg.d_model, cfg.vocab_size)}
    for name, (k, n) in shapes.items():
        w = (torch.randn(k, n, generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
        x = torch.randn(16, SPEC_TOKENS + 1, k, generator=gen, device="cuda").to(torch.bfloat16)
        for mode in quantize.WEIGHT_ONLY_MODES:
            qw = quantize.quantize_weight(w, mode=mode)
            if name in ("wq", "w_down"):
                cpu = quantize.quantize_weight(w.cpu(), mode=mode)
                bits = torch.uint8 if mode == "fp8" else torch.int8
                if not (torch.equal(qw.values.cpu().view(bits), cpu.values.view(bits))
                        and torch.equal(qw.scales.cpu(), cpu.scales)):
                    raise AssertionError(f"quantize {mode} {name}: the card's bits differ"
                                         " from the CPU's")
            out = quantize.weight_only_matmul(x, qw.values, qw.scales)
            ref = (x.double() @ qw.values.double()) * qw.scales.double()
            top = ref.abs().max().item()
            err = (out.double() - ref).abs().max().item() / top
            upcast = (x.float() @ qw.values.float()) * qw.scales
            upcast_err = (upcast.double() - ref).abs().max().item() / top
            fault = (x @ qw.values.to(torch.bfloat16)).float() * qw.scales
            fault_err = (fault.double() - ref).abs().max().item() / top
            log(f"weight_only_matmul {mode} {name} x{list(x.shape)} w[{k}, {n}]: error"
                f" {err:.3e} of the largest |product| {top:.4g} (limit {WEIGHT_ONLY_LIMIT:g});"
                f" fp32 upcast {upcast_err:.3e}; planted bf16-before-scale fault"
                f" {fault_err:.3e} [{card}]")
            if out.dtype != torch.float32 or out.shape != (*x.shape[:-1], n):
                raise AssertionError(f"weight_only_matmul gave {out.dtype} {list(out.shape)}")
            if not err <= WEIGHT_ONLY_LIMIT:
                raise AssertionError(f"weight_only_matmul {mode} {name}: error {err:.3e}")
            if not fault_err > WEIGHT_ONLY_LIMIT:
                raise AssertionError(f"the planted fault passed at {fault_err:.3e}")
            del qw, out, ref, upcast, fault
        del w, x
    torch.cuda.empty_cache()


def serve_example_flags(cfg, params, card: str) -> dict:
    """The serving example's engine flags on llama3_8b (bf16, the seeded
    weights): quant="fp8" through quantize_serve_params(consume=True),
    prefix_cache, prefill_chunk=512, spec_tokens=4, 4096 pages of 16, 16
    slots. 16 requests in two waves of 8, each prompt one shared 1024-token
    system prefix (64 pages) and a distinct suffix of 16..476 tokens, 32 new
    tokens each; wave 2 is submitted once wave 1's prompts are registered,
    so it hits the cache. The chunk kernel must launch exactly layers x
    (chunk-prefill steps + verify steps) times and the decode kernel never.
    Step times of a verify and a plain decode step at 16 slots, bf16 beside
    fp8. Consumes ``params``; returns the run's launches."""
    import torch

    from dstack_tpu_torch.workloads import serve
    from dstack_tpu_torch.workloads.kernels import paged

    bf16_bytes = tree_bytes(params)
    times = {("bf16", spec): step_ms(cfg, params, "none", spec, card) for spec in (0, SPEC_TOKENS)}
    t0 = time.monotonic()
    qparams = serve.quantize_serve_params(params, consume=True, mode="fp8")
    torch.cuda.synchronize()
    log(f"serve example flags: fp8 weights {tree_bytes(qparams) / 1e9:.3f} GB against bf16"
        f" {bf16_bytes / 1e9:.3f} GB, quantized in {time.monotonic() - t0:.1f} s")
    times.update({("fp8", spec): step_ms(cfg, qparams, "fp8", spec, card)
                  for spec in (0, SPEC_TOKENS)})
    torch.cuda.empty_cache()

    rng = np.random.RandomState(4)
    prefix = rng.randint(0, cfg.vocab_size, 1024).tolist()
    suffixes = [int(n) for n in np.linspace(16, 476, 16).astype(int)]
    prompts = [prefix + rng.randint(0, cfg.vocab_size, n).tolist() for n in suffixes]
    waves = [prompts[:8], prompts[8:]]
    max_new = 32
    engine = serve.ServeEngine(
        cfg,
        serve.EngineConfig(max_batch=16, num_pages=4096, page_size=16, quant="fp8",
                           prefix_cache=True, prefill_chunk=CHUNK, spec_tokens=SPEC_TOKENS),
        params=qparams,
    )
    if engine.decode_impl != "cuda" or "lm_head" in engine.params:
        raise AssertionError(f"engine runs {engine.decode_impl} on {sorted(engine.params)}")
    calls = {attr: count_calls(engine, attr) for attr in ("_chunk_fn", "_verify_fn", "_decode_fn")}
    torch.cuda.synchronize()
    paged.reset_launches()
    out = drive_runner(engine, waves, max_new)
    got = dict(paged.launches)
    for p, toks in zip(prompts, out["tokens"]):
        if len(toks) != max_new or not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"request of {len(p)} tokens returned {toks}")
    chunk_steps, verify_steps = calls["_chunk_fn"][0], calls["_verify_fn"][0]
    if got["paged_chunk_attention"] != cfg.n_layers * (chunk_steps + verify_steps):
        raise AssertionError(
            f"chunk kernel launches {got['paged_chunk_attention']} != {cfg.n_layers} layers x"
            f" ({chunk_steps} chunk-prefill + {verify_steps} verify steps)"
        )
    if got["paged_decode_attention"] or calls["_decode_fn"][0]:
        raise AssertionError(f"spec_tokens={SPEC_TOKENS} ran decode steps: {got}")
    if not verify_steps:
        raise AssertionError("no verify step ran")
    stats = engine.stats()
    if not stats["prefix_hit_rate"] > 0:
        raise AssertionError(f"wave 2 did not hit the prefix cache: {stats}")
    lat = engine.flight.latency_summary()
    n_tok = sum(len(t) for t in out["tokens"])
    log(f"serve example flags (fp8, prefix cache, prefill_chunk={CHUNK},"
        f" spec_tokens={SPEC_TOKENS}): 16 requests (1024-token shared prefix + 16..476) x"
        f" {max_new} tokens in two waves, {out['wall_s']:.2f} s, {n_tok / out['wall_s']:.1f}"
        f" tokens/s, TTFT p50 {lat['ttft_p50_ms']} ms p99 {lat['ttft_p99_ms']} ms, ITL p50"
        f" {lat['itl_p50_ms']} ms; prefix hit rate {stats['prefix_hit_rate']}, spec accept"
        f" rate {stats['spec_accept_rate']} (windowed {stats['spec_accept_rate_windowed']}),"
        f" cached pages {stats['cached_pages']}; chunk-prefill steps {chunk_steps}, verify"
        f" steps {verify_steps}, launches {got} [{card}]")
    log(f"serve step times at 16 slots (median of 8): bf16 decode"
        f" {times['bf16', 0]:.2f} ms, bf16 verify {times['bf16', SPEC_TOKENS]:.2f} ms; fp8"
        f" decode {times['fp8', 0]:.2f} ms, fp8 verify {times['fp8', SPEC_TOKENS]:.2f} ms [{card}]")
    del engine, qparams
    torch.cuda.empty_cache()
    return got


def profile_window(label: str, run, card: str, share_of: str = "") -> None:
    """torch.profiler over run(): wall and device busy time, the share of the
    kernels whose names hold ``share_of`` (when given), and the top
    operations by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    # Kernel rows only: an operator's row repeats its kernels' time.
    events = device_kernels(prof.key_averages())
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 or float("nan")
    share = ""
    if share_of:
        ms = sum(e.self_device_time_total for e in events if share_of in e.key) / 1e3
        share = (f", {share_of} {ms:.2f} ms ({100 * ms / busy_ms:.1f}% of busy,"
                 f" {100 * ms / wall_ms:.1f}% of wall)")
    log(f"profile {label}: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms"
        f" ({100 * busy_ms / wall_ms:.1f}%){share} [{card}]")
    for e in sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:8]:
        ms = e.self_device_time_total / 1e3
        log(f"  {ms:9.3f} ms {100 * ms / busy_ms:5.1f}%  x{e.count:<5d} {e.key[:90]}")


def profile_steps(cfg, params, prompts, card: str, decode_steps: int = 5) -> None:
    """Where a step's time goes: torch.profiler over the first engine step
    (admission, whole-prompt prefill, first decode) and over the decode
    steps after it, with the decode kernels' share (the split kernel and
    its combine); then, at prefill_chunk=512, over one chunk step of 16
    slots in mid-prefill (16 prompts of 1536 tokens: the profiled step is
    their second chunk, positions 512-1023), with the chunk kernel's share."""
    from dstack_tpu_torch.workloads import serve

    engine = serve.ServeEngine(
        cfg, serve.EngineConfig(max_batch=16, num_pages=4096, page_size=16), params=params
    )
    for p in prompts:
        engine.submit(p, max_new_tokens=decode_steps + 2)

    def steps(n):
        return lambda: [engine.step() for _ in range(n)]

    profile_window("prefill step", steps(1), card)
    profile_window(f"{decode_steps} decode steps", steps(decode_steps), card,
                   share_of="paged_decode_")
    while engine.has_work():
        engine.step()
    del engine

    engine = serve.ServeEngine(
        cfg, serve.EngineConfig(max_batch=16, num_pages=4096, page_size=16, prefill_chunk=CHUNK),
        params=params,
    )
    rng = np.random.RandomState(2)
    for _ in range(16):
        engine.submit(rng.randint(0, cfg.vocab_size, 3 * CHUNK).tolist(), max_new_tokens=1)
    engine.step()  # admits all 16 and runs their first chunk
    starts = [engine.slots[s].pos for s in range(16)]
    if starts != [CHUNK] * 16:
        raise AssertionError(f"after one chunk step the slots stand at {starts}")
    profile_window(f"chunk step (16 slots mid-prefill, prefill_chunk={CHUNK})", steps(1), card,
                   share_of="paged_chunk_mma_kernel")
    while engine.has_work():
        engine.step()
    del engine


# -- phase 5: fp32 token identity ----------------------------------------------


def run_engine(engine, prompts, max_new: int, waves: int = 1):
    """Token streams of ``prompts``, submitted in ``waves`` equal waves (each
    after the one before has drained)."""
    size = -(-len(prompts) // waves)
    reqs = []
    for start in range(0, len(prompts), size):
        reqs += [engine.submit(p, max_new_tokens=max_new) for p in prompts[start:start + size]]
        steps = 0
        while engine.has_work():
            engine.step()
            steps += 1
            if steps > 10_000:
                raise RuntimeError("engine never drained")
    return [r.tokens for r in reqs]


def phase_identity():
    import torch

    from dstack_tpu_torch.workloads import model, serve
    from dstack_tpu_torch.workloads.config import get_config

    cfg = get_config("llama3_8b", n_layers=2, dtype="float32", param_dtype="float32")
    params = model.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(1), torch.device("cuda"),
        dtype=torch.float32,
    )
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist() for n in (37, 200, 513, 1000)]
    max_new = 24
    streams = {}
    for impl in ("cuda", "plain"):
        for chunk in (0, 256):
            engine = serve.ServeEngine(
                cfg,
                serve.EngineConfig(max_batch=4, num_pages=512, page_size=16,
                                   max_seq=2048, decode_impl=impl, prefill_chunk=chunk),
                params=params,
            )
            streams[impl, chunk] = run_engine(engine, prompts, max_new)
            del engine
    for chunk in (0, 256):
        if streams["cuda", chunk] != streams["plain", chunk]:
            raise AssertionError(f"prefill_chunk={chunk}: kernel engine != plain engine")
    if streams["cuda", 256] != streams["cuda", 0]:
        raise AssertionError("chunked prefill engine != whole-prompt engine")
    for p, toks in zip(prompts[:2], streams["cuda", 0][:2]):
        ref = serve.greedy_reference_decode(params, cfg, p, max_new)
        if ref != toks:
            raise AssertionError(f"engine {toks} != greedy reference {ref}")
    log("identity: fp32 kernel engine == plain engine (whole-prompt and chunk 256)"
        " == chunked == greedy reference on 2 prompts; 4 prompts x 24 tokens")
    identity_example_flags(cfg, params)
    identity_draft_head(cfg, params)
    return cfg, params


def identity_draft_head(cfg, params) -> None:
    """fp32: the draft-head engine (a seeded random head proposing
    spec_tokens=4 on the kernels, its fallback off) against greedy decoding
    (the plain engine, one token a step): with the prefix cache and chunked
    prefill in two waves sharing a prefix, and in a pool that forces
    preemption (each re-prefill must refresh the head's hidden state)."""
    import torch

    from dstack_tpu_torch.workloads import model, serve

    draft = model.init_draft_params(cfg, torch.Generator(device="cuda").manual_seed(7),
                                    torch.device("cuda"))
    rng = np.random.RandomState(3)
    prefix = rng.randint(0, cfg.vocab_size, 320).tolist()
    shared = [prefix + rng.randint(0, cfg.vocab_size, n).tolist() for n in (17, 90, 41, 150)]
    tight = [rng.randint(0, cfg.vocab_size, n).tolist() for n in (200, 190, 180, 170)]
    max_new = 24
    for label, prompts, waves, pool, feats in (
            ("two waves", shared, 2, 512, dict(prefix_cache=True, prefill_chunk=256)),
            ("preemption", tight, 1, 40, {})):
        streams, stats = {}, None
        for name, impl, extra, head in (
                ("draft head", "cuda", dict(feats, spec_tokens=SPEC_TOKENS,
                                            spec_fallback_threshold=0.0), draft),
                ("greedy", "plain", {}, None)):
            engine = serve.ServeEngine(
                cfg,
                serve.EngineConfig(max_batch=4, page_size=16, max_seq=2048, num_pages=pool,
                                   decode_impl=impl, **extra),
                params=params, draft_params=head,
            )
            streams[name] = run_engine(engine, prompts, max_new, waves)
            stats = stats or engine.stats()
            del engine
        if streams["draft head"] != streams["greedy"]:
            raise AssertionError(f"identity draft head ({label}): {streams}")
        if stats["spec_proposer"] != "draft" or (label == "preemption"
                                                 and not stats["preemptions"] >= 1):
            raise AssertionError(f"identity draft head ({label}): {stats}")
        log(f"identity draft head ({label}): fp32 kernel engine with a random draft head,"
            f" spec_tokens {SPEC_TOKENS}, == greedy plain engine; {len(prompts)} prompts x"
            f" {max_new} tokens, accept rate {stats['spec_accept_rate']}, preemptions"
            f" {stats['preemptions']}")


def identity_example_flags(cfg, params) -> None:
    """fp32, the serving example's engine flags (prefix cache, chunked
    prefill, spec_tokens=4): the kernel engine against the plain engine, and
    both against a plain engine without them; in two waves sharing a
    320-token prefix (wave 2 hits the cache), in a pool of 40 pages that
    forces preemption, and on a model that tends to repeat tokens, so that
    verify accepts drafts (on random weights it accepts almost none); then
    with quant="int8" on both sides."""
    from dstack_tpu_torch.workloads import serve

    # The repeating model: its layers write a quarter of their usual scale
    # into the residual and its lm_head leans toward the input embedding, so
    # the greedy stream often repeats its last token, which the n-gram
    # proposer drafts when it finds no match.
    repeating = dict(params, lm_head=params["lm_head"] + params["embed"].T,
                     wo=params["wo"] / 4, w_down=params["w_down"] / 4)

    rng = np.random.RandomState(2)
    prefix = rng.randint(0, cfg.vocab_size, 320).tolist()
    shared = [prefix + rng.randint(0, cfg.vocab_size, n).tolist() for n in (17, 90, 41, 150)]
    tight = [rng.randint(0, cfg.vocab_size, n).tolist() for n in (200, 190, 180, 170)]
    max_new = 24
    flags = dict(prefix_cache=True, prefill_chunk=256, spec_tokens=SPEC_TOKENS)
    runs = {
        "two waves": (params, shared, 2, dict(num_pages=512), flags),
        "preemption": (params, tight, 1, dict(num_pages=40), flags),
        "repeating model": (repeating, shared, 2, dict(num_pages=512), flags),
        "int8, two waves": (params, shared, 2, dict(num_pages=512), dict(flags, quant="int8")),
    }
    for label, (weights, prompts, waves, pool, feats) in runs.items():
        streams, stats = {}, {}
        for name, impl, f in (("cuda", "cuda", feats), ("plain", "plain", feats),
                              ("plain, no flags", "plain", {"quant": feats.get("quant", "none")})):
            engine = serve.ServeEngine(
                cfg,
                serve.EngineConfig(max_batch=4, page_size=16, max_seq=2048, decode_impl=impl,
                                   **pool, **f),
                params=weights,
            )
            streams[name] = run_engine(engine, prompts, max_new, waves)
            stats[name] = engine.stats()
            del engine
        if not streams["cuda"] == streams["plain"] == streams["plain, no flags"]:
            raise AssertionError(f"identity ({label}): {streams}")
        cuda = stats["cuda"]
        if waves > 1 and not cuda["prefix_hit_rate"] > 0:
            raise AssertionError(f"identity ({label}): no prefix hit: {cuda}")
        if label == "preemption" and not cuda["preemptions"] >= 1:
            raise AssertionError(f"identity ({label}): the pool forced no preemption: {cuda}")
        if label == "repeating model" and not cuda["spec_accept_rate"] > 0.1:
            raise AssertionError(f"identity ({label}): verify accepted no draft: {cuda}")
        log(f"identity ({label}): fp32 kernel engine == plain engine with prefix cache,"
            f" prefill_chunk 256, spec_tokens {SPEC_TOKENS}{', int8' if 'quant' in feats else ''}"
            f" == plain engine without them; {len(prompts)} prompts x {max_new} tokens, hit rate"
            f" {cuda['prefix_hit_rate']}, accept rate {cuda['spec_accept_rate']}, preemptions"
            f" {cuda['preemptions']}")


# -- phase 6: HTTP -------------------------------------------------------------


def phase_http(cfg, params) -> None:
    try:
        import aiohttp
        from aiohttp import web
    except ImportError:
        log("http: skipped (aiohttp absent)")
        return
    from dstack_tpu_torch.workloads import serve

    engine = serve.ServeEngine(
        cfg, serve.EngineConfig(max_batch=4, num_pages=64, page_size=16, max_seq=256),
        params=params,
    )
    runner = serve.EngineRunner(engine)
    prompt = [5, 6, 7, 8, 9, 10]

    async def exercise():
        app_runner = web.AppRunner(serve.create_serve_app(runner))
        await app_runner.setup()
        site = web.TCPSite(app_runner, "127.0.0.1", 0)
        await site.start()
        port = site._server.sockets[0].getsockname()[1]
        base = f"http://127.0.0.1:{port}"
        try:
            async with aiohttp.ClientSession() as session:
                body = {"prompt_tokens": prompt, "max_tokens": 8}
                async with session.post(f"{base}/generate", json=body) as resp:
                    resp.raise_for_status()
                    if "X-Dstack-Queue-Depth" not in resp.headers:
                        raise AssertionError("no X-Dstack-Queue-Depth header")
                    text = await resp.text()
                events = [ln[6:] for ln in text.splitlines() if ln.startswith("data: ")]
                if events[-1] != "[DONE]":
                    raise AssertionError(f"stream did not end with [DONE]: {events[-1]}")
                streamed = [json.loads(e)["token"] for e in events[:-1]]
                async with session.post(
                    f"{base}/generate", json={**body, "stream": False}
                ) as resp:
                    resp.raise_for_status()
                    buffered = (await resp.json())["tokens"]
                async with session.get(f"{base}/stats") as resp:
                    resp.raise_for_status()
                    stats = await resp.json()
        finally:
            await app_runner.cleanup()
        return streamed, buffered, stats

    runner.start()
    try:
        streamed, buffered, stats = asyncio.run(exercise())
    finally:
        runner.shutdown()
        runner.join(timeout=60)
    if streamed != buffered or len(streamed) != 8:
        raise AssertionError(f"streamed {streamed} != buffered {buffered}")
    if stats["finished_requests"] != 2 or stats["decode_impl"] != "cuda":
        raise AssertionError(f"unexpected /stats {stats}")
    log(f"http: POST /generate streamed == buffered ({streamed}); /stats ok")
    http_example_flags(cfg, params)


def http_example_flags(cfg, params) -> None:
    """An app on the serving example's engine flags (fp8, prefix cache,
    prefill_chunk=512, spec_tokens=4) answers two /generate requests sharing
    a 64-token prefix: both carry X-Dstack-Prefix-Hit-Rate and
    X-Dstack-Spec-Accept-Rate, the second's hit rate is above 0, and /stats
    shows the live values."""
    import aiohttp
    from aiohttp import web

    from dstack_tpu_torch.workloads import serve

    engine = serve.ServeEngine(
        cfg,
        serve.EngineConfig(max_batch=4, num_pages=64, page_size=16, max_seq=256, quant="fp8",
                           prefix_cache=True, prefill_chunk=CHUNK, spec_tokens=SPEC_TOKENS),
        params=params,
    )
    runner = serve.EngineRunner(engine)
    prefix = list(range(100, 164))

    async def exercise():
        app_runner = web.AppRunner(serve.create_serve_app(runner))
        await app_runner.setup()
        site = web.TCPSite(app_runner, "127.0.0.1", 0)
        await site.start()
        port = site._server.sockets[0].getsockname()[1]
        base = f"http://127.0.0.1:{port}"
        headers = []
        try:
            async with aiohttp.ClientSession() as session:
                for tail in ([7, 8, 9], [7, 8, 10]):
                    body = {"prompt_tokens": prefix + tail, "max_tokens": 8, "stream": False}
                    async with session.post(f"{base}/generate", json=body) as resp:
                        resp.raise_for_status()
                        if len((await resp.json())["tokens"]) != 8:
                            raise AssertionError("/generate did not return 8 tokens")
                        headers.append({h: resp.headers.get(h) for h in (
                            "X-Dstack-Prefix-Hit-Rate", "X-Dstack-Spec-Accept-Rate")})
                async with session.get(f"{base}/stats") as resp:
                    resp.raise_for_status()
                    stats = await resp.json()
        finally:
            await app_runner.cleanup()
        return headers, stats

    runner.start()
    try:
        headers, stats = asyncio.run(exercise())
    finally:
        runner.shutdown()
        runner.join(timeout=60)
    if any(v is None for h in headers for v in h.values()):
        raise AssertionError(f"gauge headers missing: {headers}")
    if not float(headers[1]["X-Dstack-Prefix-Hit-Rate"]) > 0:
        raise AssertionError(f"the second request did not hit the prefix cache: {headers}")
    live = {k: stats[k] for k in ("quant", "prefix_cache", "spec_tokens", "prefix_hit_rate",
                                  "cached_pages", "spec_accept_rate_windowed")}
    if (live["quant"], live["prefix_cache"], live["spec_tokens"]) != ("fp8", 1, SPEC_TOKENS) or (
            not live["prefix_hit_rate"] > 0 or not live["cached_pages"] > 0):
        raise AssertionError(f"unexpected /stats {stats}")
    log(f"http (example flags): both gauge headers on /generate ({headers}); /stats {live}")


# -- phase 7: the training path ------------------------------------------------

TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 5, 2, 8192


def profile_train_step(label: str, card: str, kernels: str = "flash_"):
    """An on_step hook for train.train that runs torch.profiler over the last
    step and prints the device busy share, the share of the kernels whose
    names start with ``kernels`` and the top kernels by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    clock = {}

    def on_step(step: int, loss: float) -> None:
        if step == TRAIN_STEPS - 1:
            torch.cuda.synchronize()
            prof.start()
            clock["t0"] = time.monotonic()
        elif step == TRAIN_STEPS:
            torch.cuda.synchronize()
            wall_ms = (time.monotonic() - clock["t0"]) * 1e3
            prof.stop()
            events = device_kernels(prof.key_averages())
            busy_ms = sum(e.self_device_time_total for e in events) / 1e3 or float("nan")
            flash_ms = sum(e.self_device_time_total for e in events if kernels in e.key) / 1e3
            log(f"profile train step ({label}): wall {wall_ms:.2f} ms, device busy"
                f" {busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}%), {kernels.rstrip('_')} kernels"
                f" {flash_ms:.2f} ms ({100 * flash_ms / busy_ms:.1f}% of busy) [{card}]")
            for e in sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:10]:
                ms = e.self_device_time_total / 1e3
                log(f"  {ms:9.3f} ms {100 * ms / busy_ms:5.1f}%  x{e.count:<5d} {e.key[:90]}")

    return on_step


def phase_train(card: str) -> dict:
    import torch

    from dstack_tpu_torch.workloads import train
    from dstack_tpu_torch.workloads.config import get_config, validate_config
    from dstack_tpu_torch.workloads.kernels import flash

    cfg = get_config("llama3_1b", attn_impl="flash", remat=True, remat_policy="full")
    validate_config(cfg, seq=TRAIN_SEQ)
    launches = {name: 0 for name in flash.launches}
    for grad_accum in (1, 2):
        losses = []
        profiler = profile_train_step(f"grad_accum={grad_accum}", card) if grad_accum == 1 else None

        def on_step(step, loss, profiler=profiler):
            losses.append(loss)
            if profiler is not None:
                profiler(step, loss)

        fresh_peak()
        flash.reset_launches()
        stats = train.train(cfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                            device=torch.device("cuda"), grad_accum=grad_accum,
                            on_step=on_step)
        got = default_launches(flash)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
            raise AssertionError(f"grad_accum={grad_accum}: losses {losses}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"grad_accum={grad_accum}: loss did not fall: {losses}")
        calls = cfg.n_layers * grad_accum * TRAIN_STEPS
        want = {"flash_fwd": 2 * calls, "flash_bwd_dq": calls, "flash_bwd_dkv": calls}
        if got != want:
            raise AssertionError(f"grad_accum={grad_accum}: flash launches {got} != {want}")
        for name, n in got.items():
            launches[name] += n
        log(f"train llama3_1b ({cfg.num_params() / 1e9:.3f} B params, {cfg.n_layers} layers)"
            f" batch {TRAIN_BATCH} seq {TRAIN_SEQ} grad_accum={grad_accum}: losses"
            f" {[round(x, 4) for x in losses]}, compile+first-step {stats['compile_s']:.2f} s,"
            f" step p50 {stats['p50_s'] * 1e3:.1f} ms, {stats['tokens_per_sec']:.1f} tokens/s,"
            f" {stats['tf_per_sec']:.2f} TF/s, MFU {stats['mfu']:.4f} (of 989 TFLOP/s bf16),"
            f" peak memory {peak_gb:.2f} GB, launches {got} [{card}]")
    torch.cuda.empty_cache()
    return launches


def three_steps(cfg, init, batches, mu_dtype=None):
    """(loss and grad norm per step, parameters) after an update of cfg
    (dense, or an ``moe.MoeConfig``) from ``init`` on each of ``batches``."""
    import torch

    from dstack_tpu_torch.workloads import moe, train

    optimizer = train.make_optimizer(mu_dtype=mu_dtype)
    params = {k: v.clone() for k, v in init.items()}
    if isinstance(cfg, moe.MoeConfig):
        state = moe.init_moe_train_state(cfg, optimizer, params=params)
        step = moe.make_moe_train_step(cfg, optimizer)
    else:
        state = train.init_train_state(cfg, optimizer, params=params)
        step = train.make_train_step(cfg, optimizer)
    metrics = []
    for tokens, targets in batches:
        state, m = step(state, torch.from_numpy(tokens).cuda(), torch.from_numpy(targets).cuda())
        metrics.append((m["loss"].item(), m["grad_norm"].item()))
    return metrics, {k: v.detach() for k, v in state.params.items()}


def check_same_training(name, run, ref_name, ref, rtol: float = 1e-4) -> float:
    """Losses and grad norms of two three_steps runs within ``rtol``
    relative, each parameter tensor within 1e-4 of its norm (norm-wise:
    AdamW's sign-like step can move an entry whose gradient is rounding
    noise by up to lr on one side only); returns the worst parameter
    difference."""
    (km, kp), (rm, rp) = run, ref
    for i, ((kl, kg), (rl, rg)) in enumerate(zip(km, rm)):
        if abs(kl - rl) > rtol * abs(rl) or abs(kg - rg) > rtol * abs(rg):
            raise AssertionError(f"step {i + 1}: {name} loss/grad norm {kl}/{kg} !="
                                 f" {ref_name} {rl}/{rg}")
    worst = max(float((kp[k] - rp[k]).norm() / rp[k].norm()) for k in rp)
    if worst > 1e-4:
        raise AssertionError(f"{name}: parameters after 3 steps differ by {worst:.3e} of their"
                             f" norm from {ref_name}")
    return worst


def phase_train_identity() -> None:
    """fp32, llama3_1b width with 2 layers: 3 steps on the flash kernels
    against 3 on the blockwise walk from the same parameters and batches,
    within check_same_training's tolerances."""
    import dataclasses

    import torch

    from dstack_tpu_torch.workloads import attention, data, model
    from dstack_tpu_torch.workloads.config import get_config
    from dstack_tpu_torch.workloads.kernels import flash

    base = get_config("llama3_1b", n_layers=2, dtype="float32", param_dtype="float32")
    dev = torch.device("cuda")
    init = model.init_params(base, torch.Generator(device=dev).manual_seed(3), dev)
    batches = [b for _, b in zip(range(3), data.synthetic_batches(base.vocab_size, 2, 1024, seed=3))]
    runs = {}
    for impl in ("flash", "blockwise"):
        flash.reset_launches()
        runs[impl] = three_steps(dataclasses.replace(base, attn_impl=impl), init, batches)
        if (impl == "flash") != (flash.launches["flash_fwd"] > 0):
            raise AssertionError(f"attn_impl={impl}: flash launches {flash.launches}")
    (fm, fp), (bm, bp) = runs["flash"], runs["blockwise"]
    worst = check_same_training("flash", runs["flash"], "blockwise", runs["blockwise"])
    max_abs = max(float((fp[k] - bp[k]).abs().max()) for k in bp)
    log(f"train identity: fp32 llama3_1b width, 2 layers, seq 1024: flash kernels =="
        f" blockwise over 3 steps: losses {[round(x[0], 6) for x in fm]} vs"
        f" {[round(x[0], 6) for x in bm]}, grad norms {[round(x[1], 6) for x in fm]} vs"
        f" {[round(x[1], 6) for x in bm]}, params {worst:.2e} of norm (max abs {max_abs:.2e})")
    # Every flash route launches the kernels on the card, off the public
    # kernel's 512/256/128 menu (T = 1000) and off every block (T = 63) too.
    for t, impl in ((1024, "flash_tpu"), (1024, "auto"), (1000, "auto"), (1000, "flash_tpu"),
                    (1000, "flash"), (63, "flash")):
        q = torch.randn((2, t, 16, 128), device=dev, dtype=torch.bfloat16)
        kv = torch.randn((2, t, 8, 128), device=dev, dtype=torch.bfloat16)
        flash.reset_launches()
        out = attention.attention_core(q, kv, kv, impl)
        if flash.launches["flash_fwd"] != 1:
            raise AssertionError(f"attn_impl={impl} at T={t}: flash launches {flash.launches}")
        want = torch.float32 if impl == "flash" else torch.bfloat16
        if out.dtype != want:
            raise AssertionError(f"attn_impl={impl} on bf16 q returned {out.dtype}")
        # A bf16 output may round the other way from the blockwise walk's:
        # one bf16 step, 2**-7 of the value at most.
        ref = attention.blockwise_attention(q, kv, kv)
        torch.testing.assert_close(out.float(), ref, atol=FLASH_TOL,
                                   rtol=0 if impl == "flash" else 2 ** -7)
    log("train identity: flash_tpu and auto return bf16 for bf16 q on the card; every flash"
        " route launches the forward kernel at T = 1024, 1000 and 63 and matches blockwise")


# -- phase 9: the splash training path -------------------------------------------

# The training example's single-card command line (examples/
# train-llama-v5p.dstack.yml: --attn-impl splash --attn-window 4096
# --grad-accum 4 --mu-dtype bfloat16 --remat-policy full --prefetch 2) at
# llama3_1b and seq 8192; batch 8 is the CLI's default for grad_accum 4.
SPLASH_MAIN_ARGV = ["--config", "llama3_1b", "--attn-impl", "splash", "--attn-window", "4096",
                    "--grad-accum", "4", "--mu-dtype", "bfloat16", "--remat-policy", "full",
                    "--prefetch", "2", "--seq", "8192", "--steps", "3"]


def stray_pairs(*mods) -> dict:
    """The launches of ``mods``' wrappers since their last reset that ran at
    a pair other than DEFAULT_BLOCKS, by wrapper and pair ("64x32"), and
    under "unpaired" any launches that their pair counts do not hold."""
    from dstack_tpu_torch.workloads.kernels.flash import DEFAULT_BLOCKS

    out = {}
    for mod in mods:
        for name, by_pair in mod.pair_launches.items():
            stray = {"%dx%d" % p: n for p, n in by_pair.items() if p != DEFAULT_BLOCKS}
            if sum(by_pair.values()) != mod.launches[name]:
                stray["unpaired"] = mod.launches[name] - sum(by_pair.values())
            if stray:
                out[name] = stray
    return out


def default_launches(mod) -> dict:
    """``mod``'s launches since its last reset, read from its pair counts:
    every one must have run at DEFAULT_BLOCKS. The main paths outside 17 (b)
    pass no blocks and run with main's empty autotune directory."""
    from dstack_tpu_torch.workloads.kernels.flash import DEFAULT_BLOCKS

    stray = stray_pairs(mod)
    if stray:
        raise AssertionError(f"launches off the default pair {DEFAULT_BLOCKS}: {stray}")
    return {name: by_pair[DEFAULT_BLOCKS] for name, by_pair in mod.pair_launches.items()}


def check_splash_launches(label, cfg, microbatches, steps) -> dict:
    """The splash launches of a run: exactly 2 x layers x microbatches x
    steps forwards (the forward and again under remat) and layers x
    microbatches x steps of each backward kernel; no flash launch."""
    from dstack_tpu_torch.workloads.kernels import flash, splash

    got = default_launches(splash)
    calls = cfg.n_layers * microbatches * steps
    want = {"splash_fwd": 2 * calls, "splash_bwd_dq": calls, "splash_bwd_dkv": calls}
    if got != want or any(flash.launches.values()):
        raise AssertionError(f"{label}: splash launches {got} != {want}, flash {flash.launches}")
    return got


def phase_train_splash(card: str) -> dict:
    """train.main with the example's flags (losses finite and falling, exact
    launch counts), then train.train at batch 2 x 8192, grad_accum 1, 5
    steps, window 4096, with a profiled step, beside phase_train's flash
    run of the same shape."""
    import torch

    from dstack_tpu_torch.workloads import train
    from dstack_tpu_torch.workloads.config import get_config
    from dstack_tpu_torch.workloads.kernels import flash, splash

    cfg = get_config("llama3_1b", attn_impl="splash", attn_window=4096, remat=True,
                     remat_policy="full")
    losses = []
    inner = train.train

    def train_recording_losses(*args, **kwargs):
        return inner(*args, on_step=lambda step, loss: losses.append(loss), **kwargs)

    fresh_peak()
    splash.reset_launches()
    flash.reset_launches()
    train.train = train_recording_losses
    try:
        stats = train.main(SPLASH_MAIN_ARGV)
    finally:
        train.train = inner
    torch.cuda.synchronize()
    launches = check_splash_launches("train.main", cfg, 4, 3)
    MEASURED["splash_main_p50_s"] = stats["p50_s"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if len(losses) != 3 or not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train.main {' '.join(SPLASH_MAIN_ARGV)}: losses {losses}")
    log(f"train.main {' '.join(SPLASH_MAIN_ARGV)} (batch 8): losses"
        f" {[round(x, 4) for x in losses]}, compile+first-step {stats['compile_s']:.2f} s, step p50"
        f" {stats['p50_s'] * 1e3:.1f} ms, {stats['tokens_per_sec']:.1f} tokens/s,"
        f" {stats['tf_per_sec']:.2f} TF/s, MFU {stats['mfu']:.4f} (causal attention count),"
        f" peak memory {peak_gb:.2f} GB, launches {launches} [{card}]")

    losses.clear()
    profiler = profile_train_step("splash window=4096", card, kernels="splash_")

    def on_step(step, loss):
        losses.append(loss)
        profiler(step, loss)

    fresh_peak()
    splash.reset_launches()
    flash.reset_launches()
    stats = train.train(cfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                        device=torch.device("cuda"), on_step=on_step)
    got = check_splash_launches("train.train", cfg, 1, TRAIN_STEPS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train.train splash window=4096: losses {losses}")
    log(f"train llama3_1b splash window=4096 batch {TRAIN_BATCH} seq {TRAIN_SEQ} grad_accum=1"
        f" (fp32 first moment, as phase 7): losses {[round(x, 4) for x in losses]}, step p50"
        f" {stats['p50_s'] * 1e3:.1f} ms p90 {stats['p90_s'] * 1e3:.1f} ms,"
        f" {stats['tokens_per_sec']:.1f} tokens/s, {stats['tf_per_sec']:.2f} TF/s, MFU"
        f" {stats['mfu']:.4f} (causal attention count), peak memory {peak_gb:.2f} GB,"
        f" launches {got} [{card}]")
    for name, n in got.items():
        launches[name] += n
    torch.cuda.empty_cache()
    return launches


def phase_splash_identity() -> None:
    """fp32, llama3_1b width with 2 layers, seq 1024, window 256: 3 steps on
    the splash kernels against 3 with attention on splash_reference, from
    the same parameters and batches, with the fp32 and the bf16 first
    moment, within check_same_training's tolerances. Then attention_core's
    splash route launches the forward kernel at T = 1000 and 63."""
    import torch

    from dstack_tpu_torch.workloads import attention, data, model
    from dstack_tpu_torch.workloads.config import get_config
    from dstack_tpu_torch.workloads.kernels import splash

    cfg = get_config("llama3_1b", n_layers=2, dtype="float32", param_dtype="float32",
                     attn_impl="splash", attn_window=256)
    dev = torch.device("cuda")
    init = model.init_params(cfg, torch.Generator(device=dev).manual_seed(4), dev)
    batches = [b for _, b in zip(range(3), data.synthetic_batches(cfg.vocab_size, 2, 1024, seed=4))]
    for mu_dtype in (None, "bfloat16"):
        splash.reset_launches()
        kernels = three_steps(cfg, init, batches, mu_dtype)
        if splash.launches["splash_fwd"] != 2 * 3 * cfg.n_layers:
            raise AssertionError(f"splash identity: launches {splash.launches}")
        attention.splash_attention = splash.splash_reference
        try:
            splash.reset_launches()
            reference = three_steps(cfg, init, batches, mu_dtype)
        finally:
            attention.splash_attention = splash.splash_attention
        if any(splash.launches.values()):
            raise AssertionError(f"the reference run launched {splash.launches}")
        worst = check_same_training(f"splash (mu_dtype={mu_dtype})", kernels,
                                    "splash_reference", reference)
        (km, _), (rm, _) = kernels, reference
        log(f"splash identity (mu_dtype={mu_dtype or 'float32'}): fp32 llama3_1b width, 2 layers,"
            f" seq 1024, window 256: splash kernels == splash_reference over 3 steps: losses"
            f" {[round(x[0], 6) for x in km]} vs {[round(x[0], 6) for x in rm]}, grad norms"
            f" {[round(x[1], 6) for x in km]} vs {[round(x[1], 6) for x in rm]}, params"
            f" {worst:.2e} of norm")
    # The splash route launches the kernel at every length on the card.
    for t, window in ((1000, 100), (63, 16)):
        q = torch.randn((2, t, 16, 128), device=dev, dtype=torch.bfloat16)
        kv = torch.randn((2, t, 8, 128), device=dev, dtype=torch.bfloat16)
        splash.reset_launches()
        out = attention.attention_core(q, kv, kv, "splash", window=window)
        if splash.launches["splash_fwd"] != 1 or out.dtype != torch.float32:
            raise AssertionError(f"splash at T={t}: launches {splash.launches}, {out.dtype}")
        ref = splash.splash_reference(q, kv, kv, window=window)
        torch.testing.assert_close(out, ref, atol=SPLASH_TOL, rtol=0)
    log("splash identity: attention_core's splash route launches the forward kernel at"
        " T = 1000 and 63 and matches splash_reference")


# -- phase 12: the trainer-to-server handoff -------------------------------------

# fp8 products on the card against fp64 sums of the same e4m3 operands, as a
# share of the largest |output|. Hopper's fp8 tensor cores keep fewer bits
# than fp32 in each partial sum of a k-block, even with cuBLAS's fp32
# promotion (use_fast_accum=False), so the card reads about 2e-4 where an
# fp32 sum reads about 1e-7; a bf16 rounding before the scales reads about
# 3e-3.
FP8_LIMIT = 1e-3
# The training example's single-card command line with --quant fp8, 4 steps.
HANDOFF_TRAIN_ARGV = SPLASH_MAIN_ARGV[:-2] + ["--quant", "fp8", "--steps", "4"]
# Phases 12-14 run llama3_1b and llama3_8b at their full widths and these
# depths (of 16 and 32 layers), and phase 16's llama3_1b runs take the same
# depth: at full depth the script passes its time limit. The cut is set in
# the environment, so that the children of phases 12-14 take it too.
DEPTH_CUTS = {"llama3_1b": 4, "llama3_8b": 8}
DEPTH_ENV = "CHIP_SMOKE_DEPTH_CUTS"


def cut_depths(layers: dict) -> None:
    """The presets of ``layers`` (name -> layer count) at those depths in
    this process."""
    import dataclasses

    from dstack_tpu_torch.workloads import config

    for name, n in layers.items():
        config.PRESETS[name] = dataclasses.replace(config.PRESETS[name], n_layers=n)


class cut_depth:
    """While active, the presets of ``layers`` have those depths here and in
    every child process started meanwhile."""

    def __init__(self, layers: dict):
        self.layers = layers

    def __enter__(self):
        from dstack_tpu_torch.workloads import config

        self.presets = {name: config.PRESETS[name] for name in self.layers}
        os.environ[DEPTH_ENV] = json.dumps(self.layers)
        cut_depths(self.layers)
        return self

    def __exit__(self, *exc):
        from dstack_tpu_torch.workloads import config

        os.environ.pop(DEPTH_ENV, None)
        config.PRESETS.update(self.presets)


if os.environ.get(DEPTH_ENV):  # a child process of phases 12-14
    cut_depths(json.loads(os.environ[DEPTH_ENV]))
# What the handoff writes at most: two llama3_1b TrainStates with a bf16
# first moment (8.7 GB each) and a DraftTrainState (3.5 GB), with room.
HANDOFF_DISK_BYTES = 30e9
# The fp8 training runs of phases 12 and 13 read a token file (--data): its
# windows are global, so every mesh reads the same batches, where the
# synthetic stream draws one block per data shard. 64 windows of 8193
# tokens hold 8 global batches of 8.
TOKEN_WINDOWS = 64


def write_token_file(path: str, vocab: int, seq: int) -> str:
    """A seeded corpus of TOKEN_WINDOWS windows of seq + 1 token ids (uint16)."""
    rng = np.random.default_rng(13)
    rng.integers(0, vocab, TOKEN_WINDOWS * (seq + 1), dtype=np.uint16).tofile(path)
    return path


def quantized_projections_on_card(cfg, card: str) -> None:
    """Training's quantized products at llama3_1b's wq, w_gate and w_down
    shapes on a [2, 8192, K] bf16 x (16384 rows, one microbatch of the
    training example) and an fp32 master weight: fp8_matmul within
    FP8_LIMIT of fp64 sums of the same e4m3 operands and scales, two
    planted faults (the sum rounded to bf16 before the scales, one row's
    activation scale dropped) beyond it; int8_matmul's sums equal the exact
    (fp64) sums on every row, and its quantized values and outputs equal
    the CPU's bit for bit on 128 rows; the straight-through dx and dw equal
    the fp32 gradients of x @ w; the times of the fp8, int8 and bf16
    products."""
    import torch

    from dstack_tpu_torch.workloads import quantize

    gen = torch.Generator(device="cuda").manual_seed(9)
    shapes = {"wq": (cfg.d_model, cfg.n_heads * cfg.head_dim),
              "w_gate": (cfg.d_model, cfg.d_ff), "w_down": (cfg.d_ff, cfg.d_model)}
    for name, (k, n) in shapes.items():
        x = torch.randn(2, 8192, k, generator=gen, device="cuda").to(torch.bfloat16)
        w = torch.randn(k, n, generator=gen, device="cuda") / k ** 0.5
        x2 = x.reshape(-1, k)
        # fp8
        out = quantize.fp8_matmul(x, w)
        xq, xs = quantize.quantize_fp8(x, -1)
        wq, ws = quantize.quantize_fp8(w, 0)
        acc64 = (xq.reshape(-1, k).double() @ wq.double()).reshape(2, 8192, n)
        ref = acc64 * xs.double() * ws.double()
        top = ref.abs().max().item()
        err = (out.double() - ref).abs().max().item() / top
        acc = quantize._fp8_dot(xq.reshape(-1, k), wq).reshape(2, 8192, n)
        rounded = acc.to(torch.bfloat16).float() * xs * ws
        dropped = acc * torch.where(torch.arange(16384, device="cuda").reshape(2, 8192, 1) == 777,
                                    torch.ones_like(xs), xs) * ws
        faults = {label: (f.double() - ref).abs().max().item() / top
                  for label, f in (("bf16 before the scales", rounded),
                                   ("row 777's scale dropped", dropped))}
        if out.dtype != torch.float32 or not err <= FP8_LIMIT:
            raise AssertionError(f"fp8_matmul {name}: {out.dtype}, error {err:.3e} of the"
                                 f" largest |output| (limit {FP8_LIMIT:g})")
        for label, ferr in faults.items():
            if not ferr > FP8_LIMIT:
                raise AssertionError(f"fp8 {name}: the planted fault ({label}) passed at {ferr:.3e}")
        del acc64, ref, acc, rounded, dropped
        # int8: exact sums on every row, and the CPU's bits on a sample.
        xq8, xs8 = quantize.quantize_int8(x, -1)
        wq8, ws8 = quantize.quantize_int8(w, 0)
        sums = quantize._int8_dot(xq8.reshape(-1, k), wq8)
        if not torch.equal(sums.double(), xq8.reshape(-1, k).double() @ wq8.double()):
            raise AssertionError(f"int8 {name}: the card's int32 sums are not exact")
        out8 = quantize.int8_matmul(x, w).reshape(-1, n)
        rows = torch.arange(0, 16384, 128, device="cuda")
        cpu = quantize.int8_matmul(x2[rows].cpu(), w.cpu())
        xq_cpu, _ = quantize.quantize_int8(x2[rows].cpu(), -1)
        if not (torch.equal(out8[rows].cpu(), cpu)
                and torch.equal(xq8.reshape(-1, k)[rows].cpu(), xq_cpu)
                and torch.equal(wq8.cpu(), quantize.quantize_int8(w.cpu(), 0)[0])):
            raise AssertionError(f"int8 {name}: the card's values or outputs differ from the CPU's")
        del sums, out8, xq8, wq8
        # Straight-through gradients against the fp32 gradients of x @ w.
        g = torch.randn(2, 8192, n, generator=gen, device="cuda")
        grads = {}
        for label, fn in (("fp8", quantize.fp8_matmul_ste), ("int8", quantize.int8_matmul_ste),
                          ("fp32", lambda a, b: a.float() @ b)):
            xa, wa = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
            fn(xa, wa).backward(g)
            grads[label] = (xa.grad, wa.grad)
        ste = []
        for label in ("fp8", "int8"):
            for got, want in zip(grads[label], grads["fp32"]):
                if got.dtype != want.dtype:
                    raise AssertionError(f"{label} STE {name}: grad dtype {got.dtype} != {want.dtype}")
                diff = (got.float() - want.float()).abs().max().item()
                ste.append(diff)
                if diff > 1e-6 * want.float().abs().max().item():
                    raise AssertionError(f"{label} STE {name}: grads {diff:.3e} from the fp32 ones")
        del grads, g
        times = {"fp8": time_ms(lambda: quantize.fp8_matmul(x, w)),
                 "int8": time_ms(lambda: quantize.int8_matmul(x, w)),
                 "bf16": time_ms(lambda: x @ w.to(torch.bfloat16))}
        log(f"quantized projection {name} x[2, 8192, {k}] @ w[{k}, {n}]: fp8_matmul {err:.3e} of the"
            f" largest |output| {top:.4g} from fp64 sums (limit {FP8_LIMIT:g}); planted faults"
            f" {', '.join(f'{lb} {v:.3e}' for lb, v in faults.items())}; int8 sums exact, values"
            f" and outputs equal to the CPU's on 128 rows; STE dx, dw {max(ste):.3e} from the fp32"
            f" grads; times fp8 {times['fp8']:.4f} ms, int8 {times['int8']:.4f} ms, bf16"
            f" {times['bf16']:.4f} ms (each with its quantization) [{card}]")
        del x, w, out
        torch.cuda.empty_cache()


def param_sums(params: dict) -> dict:
    """Each leaf's fp64 sum and sum of squares: a checksum of a tree held in
    one process, to compare with the same tree read back in another."""
    out = {}
    for key, t in params.items():
        d = t.detach().double()
        out[key] = [float(d.sum()), float((d * d).sum())]
        del d
    return out


def handoff_child(kind: str, argv_json: str, report: str) -> None:
    """Run in a child process: ``train.main(argv)`` (``kind`` "train" or
    "distill"), recording every step's loss and the attention kernels'
    launches into ``report`` as JSON, also when the run ends on an injected
    crash; for "train", also ``param_sums`` of the parameters the last step
    left in memory."""
    import torch

    from dstack_tpu_torch.workloads import train
    from dstack_tpu_torch.workloads.kernels import flash, splash

    losses, last = {}, {}
    inner, make_step = getattr(train, kind), train.make_train_step

    def recording(*args, **kwargs):
        return inner(*args, on_step=lambda step, loss: losses.__setitem__(step, loss), **kwargs)

    def keeping_state(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def kept(state, *batch):
            last["state"], metrics = step(state, *batch)
            return last["state"], metrics

        return kept

    setattr(train, kind, recording)
    train.make_train_step = keeping_state
    flash.reset_launches()
    splash.reset_launches()
    stats = None
    try:
        stats = train.main(json.loads(argv_json))
    finally:
        sums = param_sums(last["state"].params) if "state" in last else None
        with open(report, "w", encoding="utf-8") as f:
            json.dump({"losses": losses, "splash": dict(splash.launches),
                       "flash": dict(flash.launches), "stray_pairs": stray_pairs(flash, splash),
                       "stats": stats, "param_sums": sums,
                       "peak_gb": torch.cuda.max_memory_allocated() / 1e9
                       if torch.cuda.is_available() else 0.0}, f)


def run_child(label: str, kind: str, argv: list, workdir: str, expect_rc: int = 0,
              env: dict = None):
    """``handoff_child`` in a new process; returns (its report, its stdout,
    its telemetry points). Fails unless it exits with ``expect_rc``."""
    import os

    report = os.path.join(workdir, f"{label}.json")
    telemetry = os.path.join(workdir, f"{label}.telemetry.jsonl")
    child_env = {k: v for k, v in os.environ.items() if k != "DSTACK_TPU_TRAIN_CRASH_AT_STEP"}
    child_env.update(env or {}, DSTACK_TPU_TELEMETRY_PATH=telemetry)
    root = os.path.dirname(os.path.abspath(__file__))
    code = "import sys, chip_smoke; chip_smoke.handoff_child(*sys.argv[1:])"
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-c", code, kind, json.dumps(argv), report],
                          cwd=root, env=child_env, capture_output=True, text=True, timeout=900)
    for line in proc.stdout.splitlines():
        log(f"  [{label}] {line}")
    if proc.returncode != expect_rc:
        raise AssertionError(f"{label}: exit {proc.returncode} (expected {expect_rc}):\n"
                             f"{proc.stderr[-4000:]}")
    with open(report, encoding="utf-8") as f:
        out = json.load(f)
    if out["stray_pairs"]:
        raise AssertionError(f"{label}: launches off the default pair {out['stray_pairs']}")
    out["losses"] = {int(s): loss for s, loss in out["losses"].items()}
    out["wall_s"] = time.monotonic() - t0
    with open(telemetry, encoding="utf-8") as f:
        points = [json.loads(line) for line in f if line.strip()]
    return out, proc.stdout, points


def marks(points: list, event: str) -> list:
    return [p for p in points if p.get("kind") == "mark" and p.get("event") == event]


def check_child_splash(label: str, report: dict, layers: int, microbatches: int, steps: int,
                       backward: bool = True) -> dict:
    """A child's splash launches: exactly 2 x layers x microbatches x steps
    forwards under remat and layers x microbatches x steps of each backward
    kernel (``backward``), or one forward a layer and step and no backward
    (the distillation's target, without gradients); no flash launch."""
    calls = layers * microbatches * steps
    want = ({"splash_fwd": 2 * calls, "splash_bwd_dq": calls, "splash_bwd_dkv": calls}
            if backward else {"splash_fwd": calls, "splash_bwd_dq": 0, "splash_bwd_dkv": 0})
    if report["splash"] != want or any(report["flash"].values()):
        raise AssertionError(f"{label}: splash launches {report['splash']} != {want},"
                             f" flash {report['flash']}")
    return report["splash"]


def step_times(points: list) -> dict:
    """{step: step_time_s} of a run's telemetry step points."""
    return {p["step"]: p["step_time_s"] for p in points if p.get("kind") == "step"}


def dir_bytes(path: str) -> int:
    import os

    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def checkpoint_marks(points: list, label: str) -> str:
    """checkpoint_start / checkpoint_end (blocked_s) / checkpoint_saved
    (write_s) brackets of a run, as a line; fails when one is missing."""
    starts, ends, saved = (marks(points, e) for e in
                           ("checkpoint_start", "checkpoint_end", "checkpoint_saved"))
    if not starts or len(starts) != len(ends) or len(saved) != len(starts):
        raise AssertionError(f"{label}: checkpoint marks start {starts} end {ends} saved {saved}")
    if any("blocked_s" not in e or e.get("failed") for e in ends) or any(
            "write_s" not in s for s in saved):
        raise AssertionError(f"{label}: checkpoint marks without timings: {ends} {saved}")
    return ", ".join(f"step {e['step']} blocked {e['blocked_s']:.3f} s write {s['write_s']:.3f} s"
                     for e, s in zip(ends, saved))


def serve_main_traffic(argv: list, waves, max_new: int) -> dict:
    """``serve.main(argv)`` with web.run_app replaced: the engine main
    builds serves ``waves`` through EngineRunner.submit (drive_runner) with
    its step functions counted; returns the run's stats, latencies, tokens,
    step counts and paged launches."""
    from aiohttp import web

    from dstack_tpu_torch.workloads import serve
    from dstack_tpu_torch.workloads.kernels import paged

    seen = {}
    create, run_app = serve.create_serve_app, web.run_app

    def capture(runner):
        seen["runner"] = runner
        return create(runner)

    def traffic(app, **kwargs):
        runner = seen["runner"]
        runner.shutdown()  # drive_runner runs its own runner over the engine
        runner.join(timeout=60)
        engine = runner.engine
        calls = {a: count_calls(engine, a) for a in ("_chunk_fn", "_verify_fn", "_decode_fn")}
        paged.reset_launches()
        out = drive_runner(engine, waves, max_new)
        seen.update(out, launches=dict(paged.launches), stats=engine.stats(),
                    lat=engine.flight.latency_summary(),
                    steps={a: c[0] for a, c in calls.items()}, engine=engine)

    serve.create_serve_app, web.run_app = capture, traffic
    try:
        serve.main(argv)
    finally:
        serve.create_serve_app, web.run_app = create, run_app
    del seen["runner"]
    return seen


def phase_handoff(card: str) -> dict:
    """The trainer-to-server handoff on llama3_1b at full width (at
    DEPTH_CUTS' depth, under ``cut_depth``):
    quantized projections on the card; the training example's command
    line with --quant fp8 and checkpoints, crashed at step 3 and resumed,
    against the same run without checkpoints; the draft head distilled
    against the step-4 target; then serve.main with the serving example's
    flags from that directory (--checkpoint-dir and --spec-model), against
    the draft head without its fallback and the n-gram proposer on the same
    traffic. Returns the kernels' launches of the paths it drives."""
    import os
    import shutil
    import tempfile

    import torch

    from dstack_tpu_torch.workloads import checkpoint, serve
    from dstack_tpu_torch.workloads.config import get_config

    cfg = get_config("llama3_1b")
    quantized_projections_on_card(cfg, card)
    workdir = tempfile.mkdtemp(prefix="chip-smoke-handoff-")
    MEASURED["handoff_dir"] = workdir
    try:
        free = shutil.disk_usage(workdir).free
        if free < HANDOFF_DISK_BYTES:
            raise RuntimeError(f"the handoff needs {HANDOFF_DISK_BYTES / 1e9:.0f} GB free under"
                               f" {workdir}; {free / 1e9:.1f} GB are")
        ckpt_dir = os.path.join(workdir, "ckpt")
        train_argv = HANDOFF_TRAIN_ARGV + [
            "--data", write_token_file(os.path.join(workdir, "tokens.bin"), cfg.vocab_size, 8192)]
        ckpt_args = ["--checkpoint-every", "2", "--checkpoint-dir", ckpt_dir, "--resume"]
        torch.cuda.empty_cache()
        crash, _, crash_points = run_child("crash", "train", train_argv + ckpt_args,
                                           workdir, expect_rc=1,
                                           env={"DSTACK_TPU_TRAIN_CRASH_AT_STEP": "3"})
        manager = checkpoint.CheckpointManager(ckpt_dir)
        if sorted(crash["losses"]) != [1, 2, 3] or manager.complete_steps() != [2]:
            raise AssertionError(f"crash run: losses {crash['losses']},"
                                 f" checkpoints {manager.complete_steps()}")
        resumed, _, resumed_points = run_child("resume", "train", train_argv + ckpt_args,
                                               workdir)
        restart = marks(resumed_points, "restart")
        if sorted(resumed["losses"]) != [3, 4] or manager.complete_steps() != [2, 4] or [
                r.get("step") for r in restart] != [2]:
            raise AssertionError(f"resumed run: losses {resumed['losses']}, checkpoints"
                                 f" {manager.complete_steps()}, restart marks {restart}")
        reference, _, reference_points = run_child("reference", "train", train_argv, workdir)
        MEASURED["fp8_reference"] = dict(reference, step_s=step_times(reference_points))
        ref = reference["losses"]
        for label, run in (("crashed", crash), ("resumed", resumed)):
            for step, loss in run["losses"].items():
                if loss != ref[step]:
                    raise AssertionError(f"{label} run's step {step} loss {loss!r} != the"
                                         f" uninterrupted run's {ref[step]!r}")
        if not all(np.isfinite(list(ref.values()))) or not ref[4] < ref[1]:
            raise AssertionError(f"fp8 training: losses {ref}")
        launches = {}
        for label, run, steps in (("crash", crash, 3), ("resume", resumed, 2),
                                  ("reference", reference, 4)):
            for name, n in check_child_splash(label, run, cfg.n_layers, 4, steps).items():
                launches[name] = launches.get(name, 0) + n
        bytes_4 = dir_bytes(os.path.join(ckpt_dir, "step-00000004"))
        p50 = reference["stats"]["p50_s"]
        bf16_p50 = MEASURED.get("splash_main_p50_s", float("nan"))
        log(f"handoff train ({' '.join(train_argv)} + checkpoints every 2): crashed at"
            f" step 3 and resumed at step 2; losses {[ref[s] for s in sorted(ref)]}, steps 3 and 4"
            f" bit-equal across the resumed and the uninterrupted run (and steps 1-3 of the"
            f" crashed one); at {cfg.n_layers} layers the fp8 step p50 {p50 * 1e3:.1f} ms (phase"
            f" 10's step at 16 layers without --quant: {bf16_p50 * 1e3:.1f} ms),"
            f" {reference['stats']['tokens_per_sec']:.1f} tokens/s,"
            f" peak memory {reference['peak_gb']:.2f} GB; checkpoint of step 4"
            f" {bytes_4 / 1e9:.3f} GB; crash run: {checkpoint_marks(crash_points, 'crash')};"
            f" resumed run: {checkpoint_marks(resumed_points, 'resume')}; process walls"
            f" {crash['wall_s']:.1f} / {resumed['wall_s']:.1f} / {reference['wall_s']:.1f} s;"
            f" launches {launches} [{card}]")

        distill_argv = ["--config", "llama3_1b", "--draft-head", "--attn-impl", "splash",
                        "--attn-window", "4096", "--checkpoint-dir", ckpt_dir, "--steps", "8",
                        "--seq", "2048"]
        distilled, stdout, distill_points = run_child("distill", "distill", distill_argv, workdir)
        losses = distilled["losses"]
        if ("draft-head: frozen target from checkpoint step 4" not in stdout
                or manager.complete_steps() != [4, 12] or sorted(losses) != list(range(1, 9))
                or not all(np.isfinite(list(losses.values()))) or not losses[8] < losses[1]):
            raise AssertionError(f"distillation: losses {losses}, checkpoints"
                                 f" {manager.complete_steps()}")
        for name, n in check_child_splash("distill", distilled, cfg.n_layers, 1, 8,
                                          backward=False).items():
            launches[name] += n
        log(f"handoff distill ({' '.join(distill_argv)}): target from step 4, saved at step 12;"
            f" losses {[round(losses[s], 4) for s in sorted(losses)]}, step p50"
            f" {distilled['stats']['p50_s'] * 1e3:.1f} ms; DraftTrainState"
            f" {dir_bytes(os.path.join(ckpt_dir, 'step-00000012')) / 1e9:.3f} GB,"
            f" {checkpoint_marks(distill_points, 'distill')}; splash launches"
            f" {distilled['splash']} [{card}]")

        # The served weights are the trained ones: .params of step 12 (the
        # DraftTrainState the distillation wrote) read back here carry the
        # same per-leaf checksums as the parameters the resumed run held in
        # memory after its step 4.
        served, _ = serve.load_serve_params(ckpt_dir, cfg, step=12)
        got, want = param_sums(served), resumed["param_sums"]
        differ = [k for k in want if got.get(k) != want[k]]
        if not want or sorted(got) != sorted(want) or differ:
            raise AssertionError(f"step 12's .params differ from the trained state in"
                                 f" {differ or sorted(set(got) ^ set(want or {}))}")
        checksum = sum(s for s, _ in want.values())
        del served
        torch.cuda.empty_cache()

        rng = np.random.RandomState(6)
        prefix = rng.randint(0, cfg.vocab_size, 1024).tolist()
        suffixes = [int(n) for n in np.linspace(16, 476, 16).astype(int)]
        prompts = [prefix + rng.randint(0, cfg.vocab_size, n).tolist() for n in suffixes]
        waves = [prompts[:8], prompts[8:]]
        max_new = 32
        serve_argv = ["--config", "llama3_1b", "--port", "0", "--max-batch", "16", "--pages",
                      "4096", "--page-size", "16", "--quant", "fp8", "--prefix-cache",
                      "--prefill-chunk", str(CHUNK), "--spec-tokens", str(SPEC_TOKENS),
                      "--checkpoint-dir", ckpt_dir]
        runs = {}
        for label, proposer, extra in (
                ("draft", "draft", ["--spec-model", ckpt_dir]),
                ("draft, no fallback", "draft",
                 ["--spec-model", ckpt_dir, "--spec-fallback-threshold", "0"]),
                ("ngram", "ngram", [])):
            run = serve_main_traffic(serve_argv + extra, waves, max_new)
            engine, stats, steps = run.pop("engine"), run["stats"], run["steps"]
            for p, toks in zip(prompts, run["tokens"]):
                if len(toks) != max_new or not all(0 <= t < cfg.vocab_size for t in toks):
                    raise AssertionError(f"{proposer}: a request of {len(p)} tokens returned {toks}")
            chunk_steps, verify_steps = steps["_chunk_fn"], steps["_verify_fn"]
            got = run["launches"]
            if (got["paged_chunk_attention"] != cfg.n_layers * (chunk_steps + verify_steps)
                    or got["paged_decode_attention"] or steps["_decode_fn"] or not verify_steps):
                raise AssertionError(f"{proposer}: launches {got}, steps {steps}")
            if stats["spec_proposer"] != proposer or "lm_head" in engine.params or not (
                    stats["prefix_hit_rate"] > 0):
                raise AssertionError(f"{proposer}: {stats}")
            del engine
            torch.cuda.empty_cache()
            runs[label] = run
            n_tok = sum(len(t) for t in run["tokens"])
            lat = run["lat"]
            log(f"handoff serve ({label}; serve.main {' '.join(serve_argv + extra)}):"
                f" 16 requests x {max_new} tokens in two waves, {run['wall_s']:.2f} s,"
                f" {n_tok / run['wall_s']:.1f} tokens/s, TTFT p50 {lat['ttft_p50_ms']} ms p99"
                f" {lat['ttft_p99_ms']} ms, ITL p50 {lat['itl_p50_ms']} ms; prefix hit rate"
                f" {stats['prefix_hit_rate']}, spec accept rate {stats['spec_accept_rate']}"
                f" (windowed {stats['spec_accept_rate_windowed']}), spec_fallbacks"
                f" {stats['spec_fallbacks']}; chunk-prefill steps {chunk_steps}, verify steps"
                f" {verify_steps}, launches {got} [{card}]")
            launches["paged_chunk_attention"] = (launches.get("paged_chunk_attention", 0)
                                                 + got["paged_chunk_attention"])
            launches["paged_decode_attention"] = (launches.get("paged_decode_attention", 0)
                                                  + got["paged_decode_attention"])
        log(f"handoff: the served .params (step 12, read back) carry the per-leaf fp64 sums"
            f" and sums of squares of the resumed run's parameters in memory after step 4"
            f" ({len(want)} leaves, total sum {checksum!r}); spec accept rate of the draft head alone"
            f" {runs['draft, no fallback']['stats']['spec_accept_rate']}, with the fallback"
            f" {runs['draft']['stats']['spec_accept_rate']} ({runs['draft']['stats']['spec_fallbacks']}"
            f" fallbacks), of the n-gram proposer {runs['ngram']['stats']['spec_accept_rate']}, on"
            f" the same traffic (a head distilled 8 steps against random weights) [{card}]")
    except BaseException:
        shutil.rmtree(workdir, ignore_errors=True)
        raise
    # Phase 14 serves step 12 again; main removes the directory at the end.
    shutil.rmtree(os.path.join(ckpt_dir, "step-00000004"), ignore_errors=True)
    MEASURED["handoff_ckpt"] = ckpt_dir
    return launches


# -- phase 13: the training mesh ----------------------------------------------

# The training example's mesh flags at llama3_1b (--tp 2 --tp-overlap
# --fsdp-overlap); JAX's validation refuses the rings on one device, so one
# card runs --tp 1 without them.
MESH_FLAGS = ["--tp", "2", "--tp-overlap", "--fsdp-overlap"]
# Runs on several ranks against one rank's: the CPU tests' limit for fp8
# steps whose sums round differently (tests/test_torch_train_mesh.py).
MESH_QUANT_RTOL = 3e-3


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_ranks(label: str, code: str, args: list, world: int, workdir: str, timeout: float,
              ) -> list:
    """``python -c code *args <report>`` on ``world`` ranks under torchrun's
    environment (RANK, LOCAL_RANK, WORLD_SIZE, MASTER_ADDR=127.0.0.1 and a
    free MASTER_PORT; one card a rank, NCCL), each with its own report and
    telemetry file. Returns [(report, stdout, telemetry points)] by rank.
    Every rank must exit 0 within ``timeout`` seconds; past it (a hung
    collective) all are killed and the phase fails."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    port = free_port()
    procs, files = [], []
    for rank in range(world):
        report = os.path.join(workdir, f"{label}.rank{rank}.json")
        telemetry = os.path.join(workdir, f"{label}.rank{rank}.telemetry.jsonl")
        env = {k: v for k, v in os.environ.items() if k != "DSTACK_TPU_TRAIN_CRASH_AT_STEP"}
        env.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   DSTACK_TPU_TELEMETRY_PATH=telemetry)
        procs.append(subprocess.Popen([sys.executable, "-c", code, *args, report], cwd=root,
                                      env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
        files.append((report, telemetry))
    t0 = time.monotonic()
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=max(1.0, timeout - (time.monotonic() - t0))))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"{label}: the {world} ranks did not finish in {timeout:.0f} s")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.monotonic() - t0
    for line in outs[0][0].splitlines():
        log(f"  [{label} rank 0] {line}")
    failed = [(rank, proc.returncode, err) for rank, (proc, (_, err)) in
              enumerate(zip(procs, outs)) if proc.returncode != 0]
    if failed:
        raise AssertionError(f"{label}: exit codes {[p.returncode for p in procs]}:\n" + "\n".join(
            f"rank {rank} (exit {rc}): {err[-3000:]}" for rank, rc, err in failed))
    results = []
    for stdout_err, (report, telemetry) in zip(outs, files):
        stdout = stdout_err[0]
        with open(report, encoding="utf-8") as f:
            out = json.load(f)
        if out.get("stray_pairs"):
            raise AssertionError(f"{label}: launches off the default pair {out['stray_pairs']}")
        if "losses" in out:
            out["losses"] = {int(s): loss for s, loss in out["losses"].items()}
        out["wall_s"] = wall
        points = []
        if os.path.exists(telemetry):
            with open(telemetry, encoding="utf-8") as f:
                points = [json.loads(line) for line in f if line.strip()]
        results.append((out, stdout, points))
    return results


def run_train_ranks(label: str, argv: list, world: int, workdir: str, timeout: float) -> list:
    code = "import sys, chip_smoke; chip_smoke.handoff_child(*sys.argv[1:])"
    return run_ranks(label, code, ["train", json.dumps(argv)], world, workdir, timeout)


def mesh_rings_child(report: str) -> None:
    """Run on each rank of a tp 2 mesh (torchrun's environment): each ring
    of the training example's flags at llama3_1b's shapes (one microbatch of
    batch 8, grad_accum 4, seq 8192; w_down through the reduce-scatter ring,
    and with two data ranks or more w_gate through the all-gather ring)
    against its plain collective (gather on use, the product, the tp
    all-reduce): the outputs of the fp products compared, then CUDA-event
    medians of forward and backward with fp8 partials, as the example runs
    them."""
    import torch

    from dstack_tpu_torch.workloads import quantize, sharding
    from dstack_tpu_torch.workloads.config import get_config
    from dstack_tpu_torch.workloads.kernels import collective

    dev = sharding.init_distributed(torch.device("cuda"))
    try:
        mesh = sharding.make_mesh(tp=2).connect(dev)
        cfg = get_config("llama3_1b")
        data, tp = mesh.axis_size(sharding.DATA_AXES), mesh.shape["tp"]
        rows, bf16 = 2 // data, torch.bfloat16
        gen = torch.Generator(device=dev).manual_seed(13 + mesh.index(sharding.DATA_AXES))

        def randn(*shape, dtype=bf16, scale=1.0):
            t = torch.randn(shape, generator=gen, device=dev) * scale
            return t.to(dtype).requires_grad_(True)

        hidden = randn(rows, 8192, cfg.d_ff // tp)
        w_down = randn(cfg.d_ff // tp, cfg.d_model // data, dtype=torch.float32,
                       scale=cfg.d_ff ** -0.5)
        x = randn(rows, 8192, cfg.d_model)
        w_gate = randn(cfg.d_model // data, cfg.d_ff // tp, dtype=torch.float32,
                       scale=cfg.d_model ** -0.5)
        reduce = collective.max_over(mesh, "tp")

        def down(ring, fp8):
            whole = collective.gather_on_use(w_down, 1, mesh, sharding.DATA_AXES,
                                             None if fp8 else bf16)
            if ring:
                return collective.collective_matmul(hidden, whole, mesh,
                                                    matmul=quantize.FP8_DOT if fp8 else None)
            y = quantize.fp8_matmul_ste(hidden, whole, reduce) if fp8 else hidden @ whole
            return collective.reduce_forward(y.float(), mesh, "tp")

        def up(ring, fp8):
            xin = collective.reduce_backward(x, mesh, "tp")
            if ring:
                return collective.allgather_matmul(xin, w_gate, mesh,
                                                   matmul=quantize.FP8_DOT if fp8 else None,
                                                   dtype=None if fp8 else bf16)
            whole = collective.gather_on_use(w_gate, 0, mesh, sharding.DATA_AXES,
                                             None if fp8 else bf16)
            return (quantize.fp8_matmul_ste(xin, whole) if fp8 else xin @ whole).float()

        def fwd_bwd(fn, ring):
            def run():
                y = fn(ring, True)
                y.backward(torch.ones_like(y))
            return run

        out = {}
        for name, fn in [("collective_matmul", down)] + ([("allgather_matmul", up)]
                                                         if data > 1 else []):
            with torch.no_grad():
                plain = fn(False, False)
                gap = (fn(True, False) - plain).abs().max().item()
                scale = plain.abs().max().item()
            out[name] = dict(ms=time_ms(fwd_bwd(fn, True), iters=5, warmup=2),
                             plain_ms=time_ms(fwd_bwd(fn, False), iters=5, warmup=2),
                             max_gap=gap, scale=scale)
        with open(report, "w", encoding="utf-8") as f:
            json.dump(out, f)
    finally:
        torch.distributed.destroy_process_group()


def phase_mesh(card: str) -> dict:
    """The training mesh on llama3_1b at full width (phase 12's depth), through
    train.main under torchrun's environment with the training example's
    flags and --quant fp8 (phase 12's command line) on phase 12's token
    file: (a) up to two cards as one rank each (--tp 1, no rings), 2
    steps and a checkpoint, against phase 12's meshless run; (b) its
    step-2 checkpoint resumed meshless, and that run's step-3 checkpoint
    resumed on the mesh, on one rank each step bit-equal to the meshless
    run; (c) on two cards, --tp 2 --tp-overlap, on four or more, 4 of them
    with --tp 2 --tp-overlap --fsdp-overlap, against (a), and each ring
    timed against its plain collective. Returns the kernels' launches of
    the runs."""
    import os
    import shutil
    import tempfile

    import torch

    from dstack_tpu_torch.workloads import checkpoint
    from dstack_tpu_torch.workloads.config import get_config

    cfg = get_config("llama3_1b")
    reference = MEASURED["fp8_reference"]
    ref = reference["losses"]
    cards = torch.cuda.device_count()
    workdir = tempfile.mkdtemp(prefix="chip-smoke-mesh-")
    try:
        free = shutil.disk_usage(workdir).free
        if free < HANDOFF_DISK_BYTES:
            raise RuntimeError(f"the mesh phase needs {HANDOFF_DISK_BYTES / 1e9:.0f} GB free under"
                               f" {workdir}; {free / 1e9:.1f} GB are")
        ckpt_dir = os.path.join(workdir, "ckpt")
        base = HANDOFF_TRAIN_ARGV[:-2] + [
            "--batch", "8", "--data",
            write_token_file(os.path.join(workdir, "tokens.bin"), cfg.vocab_size, 8192)]
        torch.cuda.empty_cache()
        launches = {}

        def count(label, report, microbatches, steps):
            for name, n in check_child_splash(label, report, cfg.n_layers, microbatches,
                                              steps).items():
                launches[name] = launches.get(name, 0) + n

        # (a) the mesh of the cards, a checkpoint at its last step, 2. The
        # example's batch of 8 in 4 microbatches has 2 rows a microbatch: at
        # most 2 data ranks.
        ranks = min(cards, 2)
        argv_a = base + ["--steps", "2", "--tp", "1", "--checkpoint-every", "2",
                         "--checkpoint-dir", ckpt_dir]
        ranks_a = run_train_ranks("mesh", argv_a, ranks, workdir, timeout=420)
        mesh_run, stdout, points = ranks_a[0]
        manager = checkpoint.CheckpointManager(ckpt_dir)
        manifest = manager.read_manifest(2)
        want_mesh = {"dp": 1, "fsdp": ranks, "tp": 1, "sp": 1}
        if (f"mesh={want_mesh}" not in stdout or manifest["mesh"] != want_mesh
                or manifest["process_count"] != ranks or manager.complete_steps() != [2]):
            raise AssertionError(f"mesh run: manifest {manifest['mesh']},"
                                 f" {manifest['process_count']} processes, checkpoints"
                                 f" {manager.complete_steps()}")
        start = marks(points, "run_start")
        if not start or start[0].get("mesh") != want_mesh or {p.get("proc") for p in points} != {0}:
            raise AssertionError(f"mesh run telemetry: run_start {start}")
        waits = [p for p in points if p.get("kind") == "step" and "collective_wait_s" in p]
        if bool(waits) != (ranks > 1):
            raise AssertionError(f"mesh run: collective_wait_s on {len(waits)} step points"
                                 f" with {ranks} ranks")
        gaps = {s: abs(mesh_run["losses"][s] - ref[s]) / abs(ref[s]) for s in (1, 2)}
        bit_equal = all(mesh_run["losses"][s] == ref[s] for s in (1, 2))
        # One rank runs the meshless arithmetic; on two, the gradient sums
        # over ranks round otherwise, and fp8 turns that into grid flips.
        if max(gaps.values()) > (1e-5 if ranks == 1 else MESH_QUANT_RTOL):
            raise AssertionError(f"mesh run's losses {mesh_run['losses']} against the meshless"
                                 f" run's {ref}: relative gaps {gaps}")
        for rank, (report, _, _) in enumerate(ranks_a):
            count(f"mesh rank {rank}", report, 4, 2)
        # Step 2, the first after compilation, runs with no checkpoint write
        # in flight in either run.
        step2, ref_step2 = step_times(points)[2], reference["step_s"][2]
        ref_p50 = reference["stats"]["p50_s"]
        log(f"mesh (a) train.main {' '.join(argv_a)} on {ranks} rank(s), NCCL, mesh {want_mesh}:"
            f" losses {[mesh_run['losses'][s] for s in (1, 2)]}, "
            + ("bit-equal to" if bit_equal else f"relative gaps {gaps} from")
            + f" the meshless run's (phase 12); step 2 {step2 * 1e3:.1f} ms against"
            f" {ref_step2 * 1e3:.1f} ms meshless ({(step2 / ref_step2 - 1) * 100:+.2f}%; the"
            f" meshless step p50 {ref_p50 * 1e3:.1f} ms), peak memory"
            f" {mesh_run['peak_gb']:.2f} GB against {reference['peak_gb']:.2f} GB; checkpoints"
            f" {checkpoint_marks(points, 'mesh')}; splash launches {mesh_run['splash']} a rank"
            f" [{card}]")

        # (b) the mesh's step-2 checkpoint resumed meshless, and back.
        to_meshless, _, points = run_child(
            "mesh-to-meshless", "train",
            base + ["--steps", "3", "--checkpoint-every", "2", "--checkpoint-dir", ckpt_dir,
                    "--resume"], workdir)
        restart = marks(points, "restart")
        if (sorted(to_meshless["losses"]) != [3] or [r.get("from_mesh") for r in restart]
                != [want_mesh] or manager.complete_steps() != [2, 3]):
            raise AssertionError(f"meshless resume: losses {to_meshless['losses']}, restart"
                                 f" {restart}, checkpoints {manager.complete_steps()}")
        count("mesh-to-meshless", to_meshless, 4, 1)
        ranks_b = run_train_ranks(
            "meshless-to-mesh", base + ["--steps", "4", "--tp", "1", "--checkpoint-dir",
                                        ckpt_dir, "--resume"], ranks, workdir, timeout=300)
        to_mesh, _, points = ranks_b[0]
        restart = marks(points, "restart")
        if sorted(to_mesh["losses"]) != [4] or [r.get("from_mesh") for r in restart] != [None]:
            raise AssertionError(f"mesh resume: losses {to_mesh['losses']}, restart {restart}")
        for rank, (report, _, _) in enumerate(ranks_b):
            count(f"meshless-to-mesh rank {rank}", report, 4, 1)
        resumed = {3: to_meshless["losses"][3], 4: to_mesh["losses"][4]}
        # On one rank the resumed runs must be bit-equal to the uninterrupted
        # one; on two, each resumed step rounds as its own layout does.
        gaps = {s: abs(resumed[s] - ref[s]) / abs(ref[s]) for s in (3, 4)}
        if (ranks == 1 and resumed != {3: ref[3], 4: ref[4]}) or max(
                gaps.values()) > MESH_QUANT_RTOL:
            raise AssertionError(f"resumed losses {resumed} against the uninterrupted run's"
                                 f" {ref[3]!r}, {ref[4]!r}")
        log(f"mesh (b): the mesh's step-2 checkpoint resumed meshless (step 3 loss"
            f" {resumed[3]!r}) and that run's step-3 checkpoint resumed on the mesh (step 4 loss"
            f" {resumed[4]!r}), "
            + ("both bit-equal to" if ranks == 1 else f"relative gaps {gaps} from")
            + f" the uninterrupted meshless run; process walls {to_meshless['wall_s']:.1f} /"
            f" {to_mesh['wall_s']:.1f} s [{card}]")

        # (c) the rings, on the cards there are.
        if cards < 2:
            log(f"mesh multi-rank: not run ({cards} card visible) [{card}]")
            return launches
        # tp 2 takes two ranks; the all-gather ring needs two data ranks
        # more (JAX's validation refuses it over one).
        world = 4 if cards >= 4 else 2
        argv_c = base + ["--steps", "2"] + (MESH_FLAGS if world == 4 else MESH_FLAGS[:3])
        ranks_c = run_train_ranks("mesh-rings", argv_c, world, workdir, timeout=420)
        rings = ranks_c[0][0]
        gaps = {s: abs(rings["losses"][s] - mesh_run["losses"][s]) / abs(mesh_run["losses"][s])
                for s in (1, 2)}
        if max(gaps.values()) > MESH_QUANT_RTOL or any(
                r["losses"] != rings["losses"] for r, _, _ in ranks_c):
            raise AssertionError(f"rings on {world} ranks: losses {rings['losses']} against"
                                 f" {mesh_run['losses']} (gaps {gaps})")
        for rank, (report, _, _) in enumerate(ranks_c):
            count(f"mesh-rings rank {rank}", report, 4, 2)
        waits = [p["collective_wait_s"] for p in ranks_c[0][2] if "collective_wait_s" in p]
        log(f"mesh (c) train.main {' '.join(argv_c)} on {world} ranks: losses"
            f" {[rings['losses'][s] for s in (1, 2)]}, relative gaps {gaps} from (a); step 2"
            f" {step_times(ranks_c[0][2])[2] * 1e3:.1f} ms, peak {rings['peak_gb']:.2f} GB a rank,"
            f" collective_wait_s {waits} (rank 0) [{card}]")
        code = "import sys, chip_smoke; chip_smoke.mesh_rings_child(*sys.argv[1:])"
        timed = run_ranks("rings-timing", code, [], world, workdir, timeout=300)[0][0]
        for name in ("collective_matmul", "allgather_matmul")[:len(timed) - 1]:
            t = timed[name]
            # The plain products round to bf16 (2^-8), the rings sum in fp32.
            if not t["max_gap"] <= 2 ** -7 * t["scale"]:
                raise AssertionError(f"{name}: ring and plain outputs differ by {t}")
            log(f"mesh ring {name} on {world} ranks: with fp8 partials, forward and backward"
                f" {t['ms']:.3f} ms against {t['plain_ms']:.3f} ms plain; fp products"
                f" {t['max_gap']:.3e} apart (largest {t['scale']:.3e}) [{card}]")
        return launches
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

# -- phase 14: the serve mesh ---------------------------------------------------

# The serving example's engine flags (examples/serve-llama.dstack.yml:53-58)
# but for --checkpoint-dir, --spec-model and --mesh, and its pool.
SERVE_EXAMPLE_ARGV = ["--max-batch", "16", "--pages", "4096", "--page-size", "16", "--quant",
                      "fp8", "--prefix-cache", "--prefill-chunk", str(CHUNK), "--spec-tokens",
                      str(SPEC_TOKENS)]
# A rank's KV heads on the serve meshes the example and the handoff run:
# (label, query heads, KV heads) of the paged kernels' per-rank shapes.
RANK_SHAPES = (("llama3_8b tp4", 8, 2), ("llama3_8b tp2", 16, 4), ("llama3_1b tp4", 4, 2))


def example_traffic(vocab: int, seed: int):
    """Phase 4's two-wave burst (``serve_example_flags``): 16 prompts, each a
    shared 1024-token prefix and a 16..476-token suffix, in two waves of 8."""
    rng = np.random.RandomState(seed)
    prefix = rng.randint(0, vocab, 1024).tolist()
    suffixes = [int(n) for n in np.linspace(16, 476, 16).astype(int)]
    prompts = [prefix + rng.randint(0, vocab, n).tolist() for n in suffixes]
    return [prompts[:8], prompts[8:]]


def gloo_cuda_probe() -> dict:
    """On every rank of a gloo world: an all-reduce and a broadcast of a
    CUDA tensor, the two collectives the serve mesh runs on the card's
    tensors; raises naming what this torch build lacks."""
    import torch
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()
    try:
        t = torch.full((4,), float(rank + 1), device="cuda")
        dist.all_reduce(t)
        b = torch.full((4,), float(rank), device="cuda")
        dist.broadcast(b, src=0)
        torch.cuda.synchronize()
    except Exception as e:
        raise RuntimeError(f"gloo in torch {torch.__version__} cannot all-reduce or broadcast a"
                           f" CUDA tensor: {e}") from e
    if t.tolist() != [world * (world + 1) / 2] * 4 or b.tolist() != [0.0] * 4:
        raise RuntimeError(f"gloo on CUDA tensors: all-reduce {t.tolist()}, broadcast {b.tolist()}")
    return {"all_reduce": t.tolist(), "broadcast": b.tolist()}


def mesh_identity_cases(vocab: int) -> dict:
    """(engine flags, prompts, waves) of phase 14 (b)'s fp32 identity."""
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, vocab, n).tolist() for n in (37, 200, 513, 100)]
    prefix = rng.randint(0, vocab, 320).tolist()
    shared = [prefix + rng.randint(0, vocab, n).tolist() for n in (17, 90, 41, 150)]
    flags = dict(prefix_cache=True, prefill_chunk=256, spec_tokens=SPEC_TOKENS)
    return {
        "whole-prompt": ({}, prompts, 1),
        "chunked": (dict(prefill_chunk=256), prompts, 1),
        "prefix cache, spec 4": (flags, shared, 2),
        "int8, prefix cache, spec 4": (dict(flags, quant="int8"), shared, 2),
    }


def mesh_identity_streams(mesh=None) -> dict:
    """fp32, llama3_8b width with 2 layers, the kernels: the streams of
    every ``mesh_identity_cases`` case, on ``mesh`` (this rank's pieces of
    the seeded tree) or meshless; and each case's paged launches."""
    import torch

    from dstack_tpu_torch.workloads import model, serve
    from dstack_tpu_torch.workloads.config import get_config
    from dstack_tpu_torch.workloads.kernels import paged

    cfg = get_config("llama3_8b", n_layers=2, dtype="float32", param_dtype="float32")
    params = model.init_params(cfg, torch.Generator(device="cuda").manual_seed(1),
                               torch.device("cuda"), dtype=torch.float32, mesh=mesh)
    out = {}
    for name, (flags, prompts, waves) in mesh_identity_cases(cfg.vocab_size).items():
        engine = serve.ServeEngine(
            cfg, serve.EngineConfig(max_batch=4, page_size=16, max_seq=2048, num_pages=512,
                                    decode_impl="cuda", **flags),
            params=params, device="cuda", mesh=mesh)
        paged.reset_launches()
        out[name] = {"streams": run_engine(engine, prompts, 16, waves),
                     "launches": dict(paged.launches), "mesh": engine.stats()["mesh"]}
        del engine
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def serve_main_run(argv: list) -> dict:
    """``serve.main(argv)`` in this process, as one rank of its mesh (or
    meshless), until the parent stops rank 0: the paged launches and step
    calls of the engine from its first request on, its stats and latencies,
    its KV pools' bytes and peak memory, and with --checkpoint-dir the
    per-leaf fp64 sums of the restored pieces before quantization."""
    import torch

    from dstack_tpu_torch.workloads import serve
    from dstack_tpu_torch.workloads.kernels import paged

    seen = {}
    create, follow, quantize = serve.create_serve_app, serve.follow, serve.quantize_serve_params

    def instrument(engine):
        seen["engine"] = engine
        seen["calls"] = {a: count_calls(engine, a) for a in ("_chunk_fn", "_verify_fn",
                                                              "_decode_fn")}
        paged.reset_launches()

    def capture(runner):
        instrument(runner.engine)
        return create(runner)

    def following(engine, sync):
        instrument(engine)
        return follow(engine, sync)

    def quantizing(params, *args, **kwargs):
        seen.setdefault("restored_sums", param_sums(params))
        return quantize(params, *args, **kwargs)

    torch.cuda.reset_peak_memory_stats()
    serve.create_serve_app, serve.follow = capture, following
    if "--checkpoint-dir" in argv:
        serve.quantize_serve_params = quantizing
    try:
        serve.main(argv)
    finally:
        serve.create_serve_app, serve.follow = create, follow
        serve.quantize_serve_params = quantize
    engine = seen.pop("engine")
    out = {"launches": dict(paged.launches),
           "steps": {a: c[0] for a, c in seen.pop("calls").items()},
           "stats": engine.stats(), "lat": engine.flight.latency_summary(),
           "pool_bytes": 2 * engine.k_pages.numel() * engine.k_pages.element_size(),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9, **seen}
    del engine
    fresh_peak()
    return out


def serve_child(plan_json: str, report: str) -> None:
    """One process of phase 14 (a rank under torchrun's environment, or a
    meshless server): with ``plan["gloo"]`` it joins a gloo world itself
    (LOCAL_RANK 0, so every rank shares cuda:0) and probes gloo on CUDA
    tensors; with ``plan["identity"]`` it runs the fp32 identity cases on
    a tp4 serve mesh; then ``serve.main`` for each argv of ``plan["serve"]``
    in turn. Writes its readings to ``report`` as JSON."""
    import os

    import torch
    import torch.distributed as dist

    from dstack_tpu_torch.workloads import sharding
    from dstack_tpu_torch.workloads.kernels import platform

    plan = json.loads(plan_json)
    platform.set_reference_matmul_precision()
    out = {}
    if plan.get("gloo"):
        torch.cuda.set_device(0)
        dist.init_process_group(
            "gloo", init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
            rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]),
            timeout=sharding.COLLECTIVE_TIMEOUT)
        out["probe"] = gloo_cuda_probe()
    if plan.get("identity"):
        mesh = sharding.make_serve_mesh(int(os.environ["WORLD_SIZE"])).connect(
            torch.device("cuda", 0))
        out["identity"] = mesh_identity_streams(mesh)
    out["runs"] = [serve_main_run(argv) for argv in plan["serve"]]
    with open(report, "w", encoding="utf-8") as f:
        json.dump(out, f)


def start_serve_ranks(label: str, plan: dict, world: int, workdir: str, torchrun: bool = True,
                      local_rank_zero: bool = False) -> list:
    """``serve_child(plan)`` in ``world`` processes under torchrun's
    environment (one card a rank, or every rank on cuda:0 with
    ``local_rank_zero``), or one process without it (``torchrun=False``).
    Returns [(process, report, log)] by rank."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    master = free_port()
    code = "import sys, chip_smoke; chip_smoke.serve_child(*sys.argv[1:])"
    out = []
    for rank in range(world):
        report = os.path.join(workdir, f"{label}.rank{rank}.json")
        log_path = os.path.join(workdir, f"{label}.rank{rank}.log")
        env = {k: v for k, v in os.environ.items()
               if k not in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                            "MASTER_PORT", "DSTACK_TPU_TELEMETRY_PATH")}
        if torchrun:
            env.update(RANK=str(rank), LOCAL_RANK="0" if local_rank_zero else str(rank),
                       WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(master))
        with open(log_path, "w", encoding="utf-8") as logf:
            proc = subprocess.Popen([sys.executable, "-c", code, json.dumps(plan), report],
                                    cwd=root, env=env, stdout=logf, stderr=subprocess.STDOUT)
        out.append((proc, report, log_path))
    return out


def _tail(path: str, n: int = 4000) -> str:
    with open(path, encoding="utf-8", errors="replace") as f:
        return f.read()[-n:]


def finish_ranks(label: str, ranks: list, timeout: float) -> list:
    """Wait for every rank (killing all past ``timeout``); fails unless
    each exited 0. Returns each rank's report."""
    t0 = time.monotonic()
    try:
        for proc, _, _ in ranks:
            proc.wait(timeout=max(1.0, timeout - (time.monotonic() - t0)))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"{label}: the ranks did not finish in {timeout:.0f} s:\n"
                             + _tail(ranks[0][2]))
    finally:
        for proc, _, _ in ranks:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    failed = [(r, proc.returncode) for r, (proc, _, _) in enumerate(ranks) if proc.returncode]
    if failed:
        raise AssertionError(f"{label}: exit codes {[p.returncode for p, _, _ in ranks]}:\n"
                             + "\n".join(f"rank {r}: {_tail(ranks[r][2])}" for r, _ in failed))
    for line in _tail(ranks[0][2], 3000).splitlines():
        log(f"  [{label} rank 0] {line}")
    reports = []
    for _, report, _ in ranks:
        with open(report, encoding="utf-8") as f:
            reports.append(json.load(f))
    return reports


def http_json(url: str, body=None, timeout: float = 60.0):
    import urllib.request

    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"} if data else {})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def wait_healthy(url: str, ranks: list, timeout: float = 600.0) -> None:
    """Until rank 0 answers /health; fails if a rank exits first."""
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        dead = [(r, p.returncode) for r, (p, _, _) in enumerate(ranks) if p.poll() is not None]
        if dead:
            raise AssertionError(f"rank(s) {dead} exited before serving:\n"
                                 + "\n".join(_tail(ranks[r][2]) for r, _ in dead))
        try:
            http_json(url + "/health", timeout=2.0)
            return
        except OSError:
            time.sleep(0.5)
    raise AssertionError(f"{url} did not come up in {timeout:.0f} s")


def http_waves(url: str, waves, max_new: int, timeout: float = 900.0) -> dict:
    """The waves through POST /generate (SSE), each request sent once the
    one before has its first token: every chunk step then prefills one
    request and every verify step runs the same [slots, C] shape, so two
    servers given the same traffic step alike whatever the timing. Returns
    the token streams and the wall."""
    import urllib.request

    prompts = [p for wave in waves for p in wave]
    tokens = [[] for _ in prompts]
    firsts = [threading.Event() for _ in prompts]
    errors = []

    def stream(i):
        try:
            body = json.dumps({"prompt_tokens": prompts[i], "max_tokens": max_new}).encode()
            req = urllib.request.Request(url + "/generate", data=body,
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                for line in resp:
                    if not line.startswith(b"data: "):
                        continue
                    data = line[6:].strip()
                    if data == b"[DONE]":
                        break
                    tokens[i].append(json.loads(data)["token"])
                    firsts[i].set()
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(f"request {i}: {e!r}")
        finally:
            firsts[i].set()

    t0 = time.monotonic()
    threads = []
    for i in range(len(prompts)):
        threads.append(threading.Thread(target=stream, args=(i,), daemon=True))
        threads[-1].start()
        if not firsts[i].wait(timeout):
            raise TimeoutError(f"request {i} had no first token in {timeout:.0f} s")
    for t in threads:
        t.join(timeout)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"HTTP traffic failed: {errors}")
    return {"tokens": tokens, "wall_s": time.monotonic() - t0}


def drive_serve_runs(label: str, ranks: list, runs: list) -> list:
    """For each (port, waves, max_new) of ``runs``, in turn: the traffic to
    rank 0's server, its /stats, and SIGTERM to rank 0, which stops that
    serve.main on every rank. Returns each run's streams, wall and stats."""
    import signal

    out = []
    for port, waves, max_new in runs:
        url = f"http://127.0.0.1:{port}"
        wait_healthy(url, ranks)
        got = http_waves(url, waves, max_new)
        got["http_stats"] = http_json(url + "/stats")
        ranks[0][0].send_signal(signal.SIGTERM)
        out.append(got)
    return out


def check_mesh_run(label: str, run: dict, layers: int, spec: bool = True) -> None:
    """A rank's serve.main run: the chunk kernel launched exactly layers x
    (chunk-prefill + verify steps) times, and with speculative decode the
    decode kernel never."""
    steps, got = run["steps"], run["launches"]
    if (got["paged_chunk_attention"] != layers * (steps["_chunk_fn"] + steps["_verify_fn"])
            or (spec and (got["paged_decode_attention"] or steps["_decode_fn"]))
            or not steps["_verify_fn"]):
        raise AssertionError(f"{label}: launches {got}, steps {steps}")


def share_equal(a: list, b: list) -> float:
    return sum(x == y for x, y in zip(a, b)) / len(a)


def agreement(a: list, b: list) -> str:
    """How far two servers' streams of the same requests agree: whole
    streams, first tokens (the prefill's), and the tokens before each
    stream's first difference."""
    before = [next((i for i, (p, q) in enumerate(zip(x, y)) if p != q), len(x))
              for x, y in zip(a, b)]
    return (f"{sum(x == y for x, y in zip(a, b))}/{len(a)} streams equal, first tokens"
            f" {sum(x[:1] == y[:1] for x, y in zip(a, b))}/{len(a)}, {np.mean(before):.2f} of"
            f" {len(a[0])} tokens before the first difference on average")


def per_rank_kernels(card: str) -> dict:
    """Rows 4 and 5 at the heads a rank holds on the serve meshes
    (``RANK_SHAPES``): the decode kernel (16 slots at KV_LENS) and the chunk
    kernel (C = 512 at VALID, and verify's C = 5 at the burst's lengths)
    against their plain versions at phase 2's limits (bf16 atol 1e-4 / rtol
    1e-3, fp32 1e-5); at llama3_8b tp4 (8 heads, 2 KV heads: the decode
    grid a quarter of the meshless one) the bf16 times beside the plain
    versions', SDPA's and the bounds. Returns the kernels line's rank_*
    entries."""
    import torch

    from dstack_tpu_torch.workloads.kernels import paged

    out = {name: {"rank_max_abs_err": 0.0} for name in paged.launches}
    for label, h, kh in RANK_SHAPES:
        for dtype, atol, rtol in ((torch.float32, 1e-5, 1e-5), (torch.bfloat16, 1e-4, 1e-3)):
            x = kernel_inputs(dtype, seed=20, h=h, kh=kh)
            args = {
                "paged_decode_attention": (x["q1"], x["k_pages"], x["v_pages"], x["table"],
                                           x["kv_lens"]),
                "paged_chunk_attention": (x["qc"], x["k_pages"], x["v_pages"], x["table"],
                                          x["starts"], x["kv_lens"]),
            }
            fns = {"paged_decode_attention": (paged.paged_decode_attention_cuda,
                                              paged.paged_decode_attention_plain),
                   "paged_chunk_attention": (paged.paged_chunk_attention_cuda,
                                             paged.paged_chunk_attention_plain)}
            for name, (kernel, plain) in fns.items():
                got, ref = kernel(*args[name]), plain(*args[name])
                torch.cuda.synchronize()
                torch.testing.assert_close(got, ref, atol=atol, rtol=rtol)
                err = float((got - ref).abs().max())
                out[name]["rank_max_abs_err"] = max(out[name]["rank_max_abs_err"], err)
                log(f"kernel {name} {str(dtype)[6:]} at {label}'s rank shape (H {h}, Kh {kh}):"
                    f" max_abs_err {err:.3e} (atol {atol:g}, rtol {rtol:g}) ok")
            c = SPEC_TOKENS + 1
            lens = [n + v for n, v in zip(BURST_LENGTHS, VERIFY_VALID)]
            y = kernel_inputs(dtype, seed=21, lens=lens, h=h, kh=kh)
            starts = torch.tensor(BURST_LENGTHS, dtype=torch.int32, device="cuda")
            vargs = (y["qc"][:, :c].contiguous(), y["k_pages"], y["v_pages"], y["table"], starts,
                     y["kv_lens"])
            got, ref = paged.paged_chunk_attention_cuda(*vargs), paged.paged_chunk_attention_plain(
                *vargs)
            rows = (torch.arange(c, device="cuda")[None, :]
                    < torch.tensor(VERIFY_VALID, device="cuda")[:, None])
            torch.testing.assert_close(got[rows], ref[rows], atol=atol, rtol=rtol)
            err = float((got[rows] - ref[rows]).abs().max())
            out["paged_chunk_attention"]["rank_max_abs_err"] = max(
                out["paged_chunk_attention"]["rank_max_abs_err"], err)
            log(f"kernel paged_chunk_attention {str(dtype)[6:]} verify C={c} at {label}'s rank"
                f" shape: max_abs_err {err:.3e} on rows i < valid ok")
            del y
            if dtype == torch.bfloat16 and label == RANK_SHAPES[0][0]:
                bounds = kernel_bounds(x)
                k_dense, v_dense = dense_kv(x)
                pos = torch.arange(k_dense.shape[2], device="cuda")
                kv = x["kv_lens"].long()
                limit = torch.minimum(kv[:, None], x["starts"].long()[:, None]
                                      + torch.arange(CHUNK, device="cuda")[None, :] + 1)
                sdpa = torch.nn.functional.scaled_dot_product_attention
                library = {
                    "paged_decode_attention": lambda: sdpa(
                        x["q1"][:, :, None, :], k_dense, v_dense,
                        attn_mask=(pos[None, :] < kv[:, None])[:, None, None, :]),
                    "paged_chunk_attention": lambda: sdpa(
                        x["qc"].transpose(1, 2), k_dense, v_dense,
                        attn_mask=(pos[None, None, :] < limit[:, :, None])[:, None]),
                }
                for name, (kernel, plain) in fns.items():
                    e = out[name]
                    e["rank_ms"] = time_ms(lambda: kernel(*args[name]))
                    e["rank_plain_ms"] = time_ms(lambda: plain(*args[name]))
                    e["rank_library_ms"] = time_ms(library[name])
                    e["rank_bound_ms"], e["rank_bound_by"] = bounds[name]
                    extra = ""
                    if name == "paged_decode_attention":
                        e["rank_device_ms"] = device_ms(lambda: kernel(*args[name]))
                        extra = (f", device time {e['rank_device_ms']:.4f} ms"
                                 f" ({e['rank_device_ms'] / e['rank_bound_ms']:.1f}x the bound)")
                    log(f"kernel {name} bf16 at {label}'s rank shape (H {h}, Kh {kh}) timing:"
                        f" CUDA events {e['rank_ms']:.4f} ms, plain {e['rank_plain_ms']:.4f} ms,"
                        f" sdpa {e['rank_library_ms']:.4f} ms, bound {e['rank_bound_ms']:.4f} ms"
                        f" ({e['rank_bound_by']}){extra} [{card}]")
                del k_dense, v_dense
            del x
            torch.cuda.empty_cache()
    return out


def phase_serve_mesh(card: str) -> dict:
    """The serving example's command line on the serve mesh, serve.main in
    child processes under torchrun's environment, against meshless servers
    on the same HTTP traffic: (a) --mesh tp1 on one rank (NCCL) on
    llama3_8b, token for token; (b) four ranks sharing the card over gloo,
    in fp32 token for token, then the handoff checkpoint (llama3_1b, the
    whole command line) and llama3_8b at --mesh tp4 in bf16, and rows 4 and
    5 at a rank's heads; (c) with four cards, NCCL, llama3_8b --mesh tp4.
    Returns the kernels' launches of the mesh runs and the rank_* entries of
    the kernels line."""
    import os
    import shutil
    import tempfile

    import torch

    from dstack_tpu_torch.workloads import serve, sharding
    from dstack_tpu_torch.workloads.config import get_config

    cfg8, cfg1 = get_config("llama3_8b"), get_config("llama3_1b")
    ckpt_dir = MEASURED["handoff_ckpt"]
    waves8, waves1 = example_traffic(cfg8.vocab_size, 4), example_traffic(cfg1.vocab_size, 6)
    max_new = 32
    argv8 = ["--config", "llama3_8b"] + SERVE_EXAMPLE_ARGV
    argv1 = (["--config", "llama3_1b"] + SERVE_EXAMPLE_ARGV
             + ["--spec-model", ckpt_dir, "--checkpoint-dir", ckpt_dir])
    cards = torch.cuda.device_count()
    launches = {"paged_chunk_attention": 0, "paged_decode_attention": 0}

    def count(run):
        for name in launches:
            launches[name] += run["launches"][name]

    def latency(run):
        lat = run["lat"]
        return (f"TTFT p50 {lat['ttft_p50_ms']} ms p99 {lat['ttft_p99_ms']} ms, ITL p50"
                f" {lat['itl_p50_ms']} ms")

    workdir = tempfile.mkdtemp(prefix="chip-smoke-serve-mesh-")
    try:
        # The meshless servers on the same traffic: the reference of every
        # comparison below.
        ports = [free_port(), free_port()]
        ranks = start_serve_ranks("meshless", {"serve": [argv8 + ["--port", str(ports[0])],
                                                         argv1 + ["--port", str(ports[1])]]},
                                  1, workdir, torchrun=False)
        traffic = drive_serve_runs("meshless", ranks, [(ports[0], waves8, max_new),
                                                       (ports[1], waves1, max_new)])
        ref8, ref1 = finish_ranks("meshless", ranks, 300)[0]["runs"]
        ref8.update(traffic[0])
        ref1.update(traffic[1])
        for label, run, layers in (("meshless llama3_8b", ref8, cfg8.n_layers),
                                   ("meshless llama3_1b", ref1, cfg1.n_layers)):
            check_mesh_run(label, run, layers)
            n_tok = sum(len(t) for t in run["tokens"])
            log(f"serve mesh reference ({label}, serve.main {' '.join(argv8 if '8b' in label else argv1)}):"
                f" 16 requests x {max_new} tokens in {run['wall_s']:.2f} s,"
                f" {n_tok / run['wall_s']:.1f} tokens/s, {latency(run)}; KV pools"
                f" {run['pool_bytes'] / 1e9:.3f} GB, peak {run['peak_gb']:.2f} GB [{card}]")

        # (a) one rank, NCCL: every collective acts on one rank.
        port = free_port()
        ranks = start_serve_ranks("mesh-tp1", {"serve": [argv8 + ["--mesh", "tp1", "--port",
                                                                  str(port)]]}, 1, workdir)
        traffic = drive_serve_runs("mesh-tp1", ranks, [(port, waves8, max_new)])
        run_a = finish_ranks("mesh-tp1", ranks, 300)[0]["runs"][0]
        run_a.update(traffic[0])
        check_mesh_run("mesh tp1", run_a, cfg8.n_layers)
        if run_a["http_stats"]["mesh"] != "dd1xtp1" or run_a["tokens"] != ref8["tokens"]:
            raise AssertionError(f"mesh tp1: /stats mesh {run_a['http_stats']['mesh']!r}, streams"
                                 f" equal to meshless {share_equal(run_a['tokens'], ref8['tokens'])}")
        count(run_a)
        log(f"serve mesh (a) serve.main {' '.join(argv8)} --mesh tp1, NCCL, one rank: streams"
            f" token-identical to the meshless server's; /stats mesh dd1xtp1; {latency(run_a)}"
            f" against meshless {latency(ref8)}; chunk-prefill steps"
            f" {run_a['steps']['_chunk_fn']}, verify steps {run_a['steps']['_verify_fn']},"
            f" launches {run_a['launches']} [{card}]")

        # (b) four ranks on the one card over gloo.
        mode = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
                              check=True, capture_output=True, text=True,
                              timeout=60).stdout.strip().splitlines()[0]
        report = {}
        if "Exclusive" in mode or "Prohibited" in mode:
            log(f"serve mesh tp4 on one card: not run (compute mode {mode}) [{card}]")
        else:
            ports = [free_port(), free_port()]
            plan = {"gloo": True, "identity": True,
                    "serve": [argv1 + ["--mesh", "tp4", "--port", str(ports[0])],
                              argv8 + ["--mesh", "tp4", "--port", str(ports[1])]]}
            ranks = start_serve_ranks("mesh-tp4-gloo", plan, 4, workdir, local_rank_zero=True)
            # Meanwhile: the meshless fp32 engines and the checkpoint's
            # slices at each rank's coordinate.
            ref_identity = mesh_identity_streams()
            restored, _ = serve.load_serve_params(ckpt_dir, cfg1, device="cuda")
            mesh = sharding.make_serve_mesh(4, world=4)
            want_sums = []
            for rank in range(4):
                want_sums.append(param_sums({
                    k: v[sharding.local_slices(sharding.SERVE_PARAM_SPECS[k], v.shape, mesh,
                                               rank)].contiguous()
                    for k, v in restored.items()}))
            del restored
            torch.cuda.empty_cache()
            traffic = drive_serve_runs("mesh-tp4-gloo", ranks, [(ports[0], waves1, max_new),
                                                                (ports[1], waves8, max_new)])
            reports = finish_ranks("mesh-tp4-gloo", ranks, 900)
            for rank, rep in enumerate(reports):
                for name, want in ref_identity.items():
                    got = rep["identity"][name]
                    if got["streams"] != want["streams"] or got["mesh"] != "dd1xtp4":
                        raise AssertionError(f"mesh tp4 fp32 ({name}) rank {rank}: streams"
                                             f" {share_equal(got['streams'], want['streams'])}"
                                             f" equal to meshless")
                    count(got)
                if rep["runs"][0]["restored_sums"] != want_sums[rank]:
                    raise AssertionError(f"mesh tp4 rank {rank}: restored pieces differ from the"
                                         f" checkpoint's slices")
                for run, layers, label in ((rep["runs"][0], cfg1.n_layers, "llama3_1b"),
                                           (rep["runs"][1], cfg8.n_layers, "llama3_8b")):
                    check_mesh_run(f"mesh tp4 {label} rank {rank}", run, layers)
                    count(run)
            log(f"serve mesh (b) gloo on CUDA tensors: {reports[0]['probe']}; compute mode {mode};"
                f" fp32 llama3_8b width, 2 layers, tp4 on the kernels token-identical to the"
                f" meshless kernel engine on every rank in {list(ref_identity)} (launches a"
                f" rank {[reports[0]['identity'][n]['launches'] for n in ref_identity]}) [{card}]")
            for (run_idx, ref, cfg, argv, label) in ((0, ref1, cfg1, argv1, "llama3_1b handoff"),
                                                      (1, ref8, cfg8, argv8, "llama3_8b")):
                runs = [rep["runs"][run_idx] for rep in reports]
                runs[0].update(traffic[run_idx])
                stats = runs[0]["http_stats"]
                if stats["mesh"] != "dd1xtp4" or (run_idx == 0 and stats["spec_proposer"]
                                                  != "draft"):
                    raise AssertionError(f"mesh tp4 {label}: /stats {stats}")
                share = share_equal(runs[0]["tokens"], ref["tokens"])
                ratio = runs[0]["pool_bytes"] / ref["pool_bytes"]
                log(f"serve mesh (b) serve.main {' '.join(argv)} --mesh tp4 on 4 ranks sharing the"
                    f" card over gloo (bf16): /stats mesh dd1xtp4; against the meshless server"
                    f" {agreement(runs[0]['tokens'], ref['tokens'])} (share {share:.4f}); KV pools {runs[0]['pool_bytes'] / 1e9:.3f}"
                    f" GB a rank against {ref['pool_bytes'] / 1e9:.3f} GB meshless ({ratio:.4f});"
                    f" chunk-prefill steps {runs[0]['steps']['_chunk_fn']}, verify steps"
                    f" {runs[0]['steps']['_verify_fn']}, launches a rank"
                    f" {[r['launches'] for r in runs]}, peak {[round(r['peak_gb'], 2) for r in runs]}"
                    + (f" GB; each rank's restored pieces carry the fp64 sums of the checkpoint's"
                       f" slices at its coordinate ({len(want_sums[0])} leaves)" if run_idx == 0
                       else " GB") + f"; times through gloo's host copies are not serving times"
                    f" [{card}]")
                if abs(ratio - 0.25) > 1e-9:
                    raise AssertionError(f"mesh tp4 {label}: KV pool ratio {ratio}")
            report = per_rank_kernels(card)

        # (c) four cards, NCCL.
        if cards < 4:
            log(f"serve mesh multi-card: not run ({cards} card visible) [{card}]")
            return {"launches": launches, "report": report}
        port = free_port()
        ranks = start_serve_ranks("mesh-tp4-nccl", {"serve": [argv8 + ["--mesh", "tp4", "--port",
                                                                       str(port)]]}, 4, workdir)
        traffic = drive_serve_runs("mesh-tp4-nccl", ranks, [(port, waves8, max_new)])
        runs = [rep["runs"][0] for rep in finish_ranks("mesh-tp4-nccl", ranks, 600)]
        runs[0].update(traffic[0])
        for rank, run in enumerate(runs):
            check_mesh_run(f"mesh tp4 nccl rank {rank}", run, cfg8.n_layers)
            count(run)
        n_tok = sum(len(t) for t in runs[0]["tokens"])
        log(f"serve mesh (c) serve.main {' '.join(argv8)} --mesh tp4 on 4 cards, NCCL: against"
            f" the meshless server {agreement(runs[0]['tokens'], ref8['tokens'])}; {n_tok / runs[0]['wall_s']:.1f} tokens/s against"
            f" {sum(len(t) for t in ref8['tokens']) / ref8['wall_s']:.1f}; {latency(runs[0])}"
            f" against meshless {latency(ref8)}; peak a rank"
            f" {[round(r['peak_gb'], 2) for r in runs]} GB against {ref8['peak_gb']:.2f} GB [{card}]")
        return {"launches": launches, "report": report}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


# -- phase 15: mixture-of-experts training ---------------------------------------

# The MoE example's command line (examples/moe-train.dstack.yml: train
# --config moe_test --steps 100); moe_test keeps its preset's blockwise
# attention, seq 2048 and the CLI's batch of 2.
MOE_EXAMPLE_ARGV = ["--config", "moe_test", "--steps", "100"]
# Mixtral-8x7B at full width (d_model 4096, d_ff 14336, 32/8 heads, 8
# experts, top-2, vocab 32000, loss_chunk 512). The one cut is depth, 32 ->
# 2 layers: at 32 the fp32 TrainState is about 747 GB, at 2 about 50.6 GB.
MIXTRAL_LAYERS, MIXTRAL_STEPS, MIXTRAL_BATCH, MIXTRAL_SEQ = 2, 5, 2, 4096
# fp32 runs that differ only in summation order: the kernels against their
# plain versions, a mesh against meshless.
MOE_TOL = 1e-5
# The MoE mesh on one card, as four gloo processes: moe_test in fp32 at
# seq 256, a global batch of 4, 2 steps.
MOE_MESH_SHAPES = {"ep4": dict(dp=1, fsdp=1, ep=4, tp=1, sp=1),
                   "dp2xep2": dict(dp=2, fsdp=1, ep=2, tp=1, sp=1)}
MOE_MESH_RUN = dict(config="moe_test", layers=2, overrides=dict(dtype="float32"), batch=4,
                    seq=256, steps=2, seed=7)
# With four cards: Mixtral width at 2 layers over NCCL, --ep 4.
MOE_CARDS_RUN = dict(config="mixtral_8x7b", layers=MIXTRAL_LAYERS,
                     overrides=dict(attn_impl="flash"), batch=4, seq=MIXTRAL_SEQ, steps=3, seed=7)
MOE_REGIONS = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine")
# GEMM kernels by name: cuBLAS's nvjet and xmma kernels, CUTLASS's; the fp32
# ones (no TF32: set_reference_matmul_precision) by their f32 / sgemm names.
GEMM_KERNELS = ("gemm", "xmma", "cutlass", "nvjet")
FP32_GEMM_KERNELS = ("f32f32_f32f32", "sgemm")


def moe_config(name: str, layers: int, **overrides):
    """An MoE preset at ``layers`` layers (the phases' one cut), with
    ``overrides``."""
    import dataclasses

    from dstack_tpu_torch.workloads.moe import MOE_PRESETS

    return dataclasses.replace(MOE_PRESETS[name], n_layers=layers, **overrides)


class drop_counter:
    """While active, counts the routing's (token, expert) claims and those
    kept within capacity, by wrapping ``moe._route``; the counts stay on the
    device until ``rate`` reads them."""

    def __enter__(self):
        from dstack_tpu_torch.workloads import moe

        self.inner, self.kept, self.claims = moe._route, [], 0

        def counting(logits, top_k, capacity):
            combine, dispatch, balance = self.inner(logits, top_k, capacity)
            self.kept.append(dispatch.sum())
            self.claims += logits.shape[0] * logits.shape[1] * top_k
            return combine, dispatch, balance

        moe._route = counting
        return self

    def __exit__(self, *exc):
        from dstack_tpu_torch.workloads import moe

        moe._route = self.inner

    def rate(self) -> float:
        import torch

        return 1.0 - float(torch.stack(self.kept).sum()) / self.claims


def profile_moe_step(card: str, steps: int, readings: dict):
    """An on_step hook for train.train that runs torch.profiler over the
    last of ``steps`` steps: the device busy share, the device time of the
    MoE regions (``moe.py``'s record_function ranges: routing, the dispatch
    einsum and its exchange, the expert GEMMs, the combine einsum; forward
    and its recompute under remat, the backward is not in the ranges), the
    flash kernels, all GEMM kernels, and the top kernels, into
    ``readings``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    clock = {}

    def on_step(step: int, loss: float) -> None:
        if step == steps - 1:
            torch.cuda.synchronize()
            prof.start()
            clock["t0"] = time.monotonic()
        elif step == steps:
            torch.cuda.synchronize()
            wall_ms = (time.monotonic() - clock["t0"]) * 1e3
            prof.stop()
            events = prof.key_averages()
            kernels = device_kernels(events)
            busy = sum(e.self_device_time_total for e in kernels) / 1e3 or float("nan")

            def kernel_ms(match) -> float:
                return sum(e.self_device_time_total for e in kernels if match(e.key)) / 1e3

            def host_ms(key: str) -> float:
                # A host row's device time: the kernels launched under it.
                return sum(e.device_time_total for e in events if e.key == key
                           and not str(e.device_type).endswith("CUDA")) / 1e3

            regions = {name: host_ms(name) for name in MOE_REGIONS}
            readings.update(
                wall_ms=wall_ms, busy_ms=busy, regions=regions,
                flash_ms=kernel_ms(lambda k: "flash_" in k),
                gemm_ms=kernel_ms(lambda k: any(s in k.lower() for s in GEMM_KERNELS)),
                fp32_gemm_ms=kernel_ms(lambda k: any(s in k.lower() for s in FP32_GEMM_KERNELS)),
                copy_ms=kernel_ms(lambda k: "copy_kernel" in k),
                optimizer_ms=kernel_ms(lambda k: "multi_tensor_apply" in k),
                bmm_backward_ms=host_ms("BmmBackward0"))
            log(f"profile moe step (mixtral width, {MIXTRAL_LAYERS} layers): wall {wall_ms:.2f}"
                f" ms, device busy {busy:.2f} ms ({100 * busy / wall_ms:.1f}%); of busy: flash"
                f" kernels {readings['flash_ms']:.2f} ms, GEMM kernels {readings['gemm_ms']:.2f}"
                f" ms ({100 * readings['gemm_ms'] / busy:.1f}%), of them fp32 GEMMs (the fp32"
                f" lm_head products and the router's) {readings['fp32_gemm_ms']:.2f} ms, dtype"
                f" copies {readings['copy_ms']:.2f} ms, the optimizer's foreach kernels"
                f" {readings['optimizer_ms']:.2f} ms [{card}]")
            log("  MoE regions, forward and its remat recompute (device ms): " + ", ".join(
                f"{name} {ms:.2f}" for name, ms in regions.items())
                + f"; the backward's batched products (BmmBackward0: the experts' and the"
                f" einsums') {readings['bmm_backward_ms']:.2f} ms")
            for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:10]:
                ms = e.self_device_time_total / 1e3
                log(f"  {ms:9.3f} ms {100 * ms / busy:5.1f}%  x{e.count:<5d} {e.key[:90]}")

    return on_step


def moe_batches(vocab: int, batch: int, seq: int, steps: int, seed: int) -> list:
    """``steps`` seeded global batches (numpy tokens, targets)."""
    from dstack_tpu_torch.workloads import data

    return [b for _, b in zip(range(steps), data.synthetic_batches(vocab, batch, seq, seed=seed))]


def moe_steps(cfg, seed: int, batches: list, device, mesh=None) -> dict:
    """Steps of the MoE train step from ``init_moe_params`` of ``seed``
    (this rank's pieces under an MoE ``mesh``) on the global ``batches``
    (this rank's rows, under sp its chunk): each step's loss, grad norm and
    wall time, and the
    peak memory."""
    import torch

    from dstack_tpu_torch.workloads import moe, train

    optimizer = train.make_optimizer()
    params = moe.init_moe_params(cfg, torch.Generator(device=device).manual_seed(seed), device,
                                 mesh=mesh)
    state = moe.init_moe_train_state(cfg, optimizer, params=params)
    step = moe.make_moe_train_step(cfg, optimizer, mesh)
    losses, norms, times = [], [], []
    for tokens, targets in batches:
        tokens, targets = train.local_batch(tokens, targets, mesh)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        state, m = step(state, torch.from_numpy(tokens).to(device),
                        torch.from_numpy(targets).to(device))
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
        times.append(time.perf_counter() - t0)
    return dict(losses=losses, norms=norms, step_s=times,
                peak_gb=torch.cuda.max_memory_allocated(device) / 1e9)


def moe_gloo_probe(device) -> dict:
    """On every rank of a gloo world, the collectives the MoE mesh step runs
    on the card's tensors: all-to-all, all-gather, reduce-scatter and
    all-reduce; raises naming what this torch build lacks."""
    import torch
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()
    try:
        x = torch.arange(world, dtype=torch.float32, device=device) + 10 * rank
        swapped = torch.empty_like(x)
        dist.all_to_all_single(swapped, x)
        gathered = torch.empty(world, device=device)
        dist.all_gather_into_tensor(gathered, torch.full((1,), float(rank), device=device))
        scattered = torch.empty(1, device=device)
        dist.reduce_scatter_tensor(scattered, torch.ones(world, device=device))
        total = torch.full((1,), float(rank), device=device)
        dist.all_reduce(total)
        torch.cuda.synchronize(device)
    except Exception as e:  # noqa: BLE001 - the phase logs it and runs without the mesh
        raise RuntimeError(f"gloo in torch {torch.__version__} cannot run the MoE mesh's"
                           f" collectives on CUDA tensors: {type(e).__name__}: {e}") from e
    want = [float(rank + 10 * r) for r in range(world)]
    if (swapped.tolist() != want or gathered.tolist() != [float(r) for r in range(world)]
            or scattered.tolist() != [float(world)]
            or total.tolist() != [world * (world - 1) / 2]):
        raise AssertionError(f"gloo on CUDA tensors: all-to-all {swapped.tolist()}, all-gather"
                             f" {gathered.tolist()}, reduce-scatter {scattered.tolist()},"
                             f" all-reduce {total.tolist()}")
    return {"all_to_all": swapped.tolist()}


def moe_mesh_child(plan_json: str, report: str) -> None:
    """One rank of an MoE mesh under torchrun's environment: over gloo with
    every rank on cuda:0 (four processes sharing one card, after
    ``moe_gloo_probe``), or over NCCL one card a rank. Runs ``moe_steps``
    on each mesh of the plan (a shape's "cfg" overrides the config there)
    and, with ``time_a2a``, times the dispatch's all-to-all at the plan's
    shapes; writes the results as JSON."""
    import dataclasses
    import os

    import torch
    import torch.distributed as dist

    from dstack_tpu_torch.workloads import sharding
    from dstack_tpu_torch.workloads.kernels import collective, platform
    from dstack_tpu_torch.workloads.moe import expert_capacity

    plan = json.loads(plan_json)
    platform.set_reference_matmul_precision()
    if plan["backend"] == "gloo":
        os.environ["LOCAL_RANK"] = "0"
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        dist.init_process_group("gloo", rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]),
                                timeout=sharding.COLLECTIVE_TIMEOUT)
    else:
        device = sharding.init_distributed(torch.device("cuda"))
    out = {}
    try:
        if plan["backend"] == "gloo":
            try:
                out["probe"] = moe_gloo_probe(device)
            except RuntimeError as e:
                out["probe_error"] = str(e)
                return
        run = plan["run"]
        cfg = moe_config(run["config"], run["layers"], **run["overrides"])
        batches = moe_batches(cfg.vocab_size, run["batch"], run["seq"], run["steps"], run["seed"])
        for name, shape in plan["shapes"].items():
            shape = dict(shape)
            shape_cfg = dataclasses.replace(cfg, **shape.pop("cfg", {}))
            torch.cuda.reset_peak_memory_stats(device)
            mesh = sharding.make_moe_mesh(**shape).connect(device)
            out[name] = moe_steps(shape_cfg, run["seed"], batches, device, mesh)
            if plan.get("time_a2a"):
                group = next(c for c in range(min(cfg.router_group, run["seq"]), 0, -1)
                             if run["seq"] % c == 0)
                groups = run["batch"] // mesh.axis_size(sharding.MOE_DATA_AXES) * (
                    run["seq"] // group)
                x = torch.randn((cfg.n_experts, groups, expert_capacity(cfg, group),
                                 cfg.d_model), device=device, dtype=torch.bfloat16)
                out[name]["a2a_ms"] = time_ms(lambda: collective.all_to_all(x, mesh, "ep"))
                out[name]["a2a_bytes"] = x.numel() * x.element_size()
    finally:
        with open(report, "w", encoding="utf-8") as f:
            json.dump(out, f)
        dist.destroy_process_group()


def moe_mixtral(card: str) -> dict:
    """(b) Mixtral width at 2 layers through train.train: losses finite and
    falling, exact flash launches, the drop rate, step p50, tokens/s, the
    phase's own model-FLOPs share, the peak against the reckoned state,
    and a profiled last step. Returns the flash launches."""
    import torch

    from dstack_tpu_torch.workloads import train
    from dstack_tpu_torch.workloads.config import validate_config
    from dstack_tpu_torch.workloads.kernels import flash

    cfg = moe_config("mixtral_8x7b", MIXTRAL_LAYERS, attn_impl="flash", remat=True,
                     remat_policy="full")
    validate_config(cfg, seq=MIXTRAL_SEQ)
    losses, readings = [], {}
    profiler = profile_moe_step(card, MIXTRAL_STEPS, readings)

    def on_step(step, loss):
        losses.append(loss)
        profiler(step, loss)

    fresh_peak()
    flash.reset_launches()
    with drop_counter() as drops:
        stats = train.train(cfg, steps=MIXTRAL_STEPS, batch=MIXTRAL_BATCH, seq=MIXTRAL_SEQ,
                            device=torch.device("cuda"), on_step=on_step)
    got = default_launches(flash)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if len(losses) != MIXTRAL_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"mixtral: losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"mixtral: loss did not fall: {losses}")
    calls = cfg.n_layers * MIXTRAL_STEPS
    want = {"flash_fwd": 2 * calls, "flash_bwd_dq": calls, "flash_bwd_dkv": calls}
    if got != want:
        raise AssertionError(f"mixtral: flash launches {got} != {want}")
    # The phase's own reckoning: 6 x the parameters a token touches, plus
    # causal attention's score products, over the step p50, against 989
    # TFLOP/s bf16 (dense peak of an H100 SXM at 700 W).
    tokens = MIXTRAL_BATCH * MIXTRAL_SEQ
    flops = tokens * (6.0 * cfg.active_params()
                      + 6.0 * cfg.n_layers * MIXTRAL_SEQ * cfg.d_model)
    p50 = stats["p50_s"]
    state_gb = cfg.num_params() * 16 / 1e9
    MEASURED["mixtral"] = dict(losses=losses, p50_s=p50, peak_gb=peak_gb, **readings)
    log(f"moe (b) mixtral_8x7b width, {cfg.n_layers} of 32 layers ({cfg.num_params() / 1e9:.3f}"
        f" B params, {cfg.active_params() / 1e9:.3f} B active), flash, remat full, batch"
        f" {MIXTRAL_BATCH} x {MIXTRAL_SEQ}, {MIXTRAL_STEPS} steps: losses"
        f" {[round(x, 4) for x in losses]}, compile+first-step {stats['compile_s']:.2f} s,"
        f" step p50 {p50 * 1e3:.1f} ms, {stats['tokens_per_sec']:.1f} tokens/s, model-FLOPs"
        f" share {flops / p50 / 989e12:.4f} (this phase's reckoning: 6 x active params + causal"
        f" attention, of 989 TFLOP/s bf16), token drop rate {drops.rate():.4f} (capacity factor"
        f" {cfg.capacity_factor}), peak memory {peak_gb:.2f} GB against a reckoned fp32"
        f" TrainState of {state_gb:.2f} GB, flash launches {got} [{card}]")
    torch.cuda.empty_cache()
    return got


def moe_identity(card: str) -> None:
    """(c) fp32 at Mixtral width, 1 layer, seq 1024: 3 steps on the flash
    kernels against 3 on the blockwise walk (plain PyTorch) from the same
    parameters and batches, losses and grad norms within MOE_TOL; then one
    --quant int8 step (fake-quantized experts, int8 attention
    projections), finite."""
    import dataclasses

    import torch

    from dstack_tpu_torch.workloads import moe
    from dstack_tpu_torch.workloads.kernels import flash

    base = moe_config("mixtral_8x7b", 1, dtype="float32", param_dtype="float32")
    dev = torch.device("cuda")
    init = moe.init_moe_params(base, torch.Generator(device=dev).manual_seed(3), dev)
    batches = moe_batches(base.vocab_size, 2, 1024, 3, seed=3)
    runs = {}
    for impl in ("flash", "blockwise"):
        flash.reset_launches()
        runs[impl] = three_steps(dataclasses.replace(base, attn_impl=impl), init, batches)
        if (impl == "flash") != (flash.launches["flash_fwd"] > 0):
            raise AssertionError(f"moe attn_impl={impl}: flash launches {flash.launches}")
    worst = check_same_training("moe flash", runs["flash"], "moe blockwise", runs["blockwise"],
                                rtol=MOE_TOL)
    (fm, _), (bm, _) = runs["flash"], runs["blockwise"]
    del runs
    quant, _ = three_steps(dataclasses.replace(base, attn_impl="flash", quant="int8"), init,
                           batches[:1])
    if not np.isfinite(quant[0]).all():
        raise AssertionError(f"moe int8 step: loss and grad norm {quant[0]}")
    log(f"moe (c) fp32 mixtral width, 1 layer, seq 1024: flash kernels == blockwise over 3"
        f" steps: losses {[x[0] for x in fm]} vs {[x[0] for x in bm]}, grad norms"
        f" {[x[1] for x in fm]} vs {[x[1] for x in bm]} (within {MOE_TOL:g}), params"
        f" {worst:.2e} of norm; one --quant int8 step: loss {quant[0][0]!r}, grad norm"
        f" {quant[0][1]!r} [{card}]")
    del init
    torch.cuda.empty_cache()


def phase_moe(card: str) -> dict:
    """Phase 15: the MoE example's command line and Mixtral width on the
    card; (a) train.main --config moe_test --steps 100 in a child process;
    (b) Mixtral width at 2 layers (moe_mixtral); (c) fp32 identity
    (moe_identity); (d) a crash at step 3 resumed from the step-2
    checkpoint, steps 3-4 bit-equal to (a); (e) one NCCL rank (--ep 1)
    bit-equal to (a), four gloo processes sharing the card at ep 4 and dp 2
    x ep 2 within MOE_TOL of meshless, and with four cards Mixtral width
    over NCCL at --ep 4. Returns the flash launches of the main paths."""
    import os
    import shutil
    import tempfile

    import torch

    workdir = tempfile.mkdtemp(prefix="chip-smoke-moe-")
    try:
        # (a) the example's command line.
        example, stdout, _ = run_child("moe-example", "train", MOE_EXAMPLE_ARGV, workdir)
        ref = example["losses"]
        losses = [ref[s] for s in range(1, 101)]
        if not all(np.isfinite(losses)) or not np.mean(losses[-10:]) < np.mean(losses[:10]):
            raise AssertionError(f"moe example: losses {losses}")
        if "mesh={'dp': 1, 'fsdp': 1, 'ep': 1, 'tp': 1, 'sp': 1}" not in stdout:
            raise AssertionError(f"moe example: no ep 1 mesh in its output:\n{stdout[-2000:]}")
        log(f"moe (a) train.main {' '.join(MOE_EXAMPLE_ARGV)} (blockwise, seq 2048, batch 2):"
            f" losses 1-5 {[round(x, 4) for x in losses[:5]]} ... 96-100"
            f" {[round(x, 4) for x in losses[-5:]]}, mean of the first 10"
            f" {np.mean(losses[:10]):.4f}, of the last 10 {np.mean(losses[-10:]):.4f}, step p50"
            f" {example['stats']['p50_s'] * 1e3:.2f} ms,"
            f" {example['stats']['tokens_per_sec']:.1f} tokens/s, peak"
            f" {example['peak_gb']:.2f} GB [{card}]")

        launches = moe_mixtral(card)
        moe_identity(card)

        # (d) a checkpointed run crashed at step 3 and resumed.
        ckpt = os.path.join(workdir, "ckpt")
        argv = ["--config", "moe_test", "--steps", "4", "--checkpoint-every", "2",
                "--checkpoint-dir", ckpt, "--resume"]
        crashed, _, _ = run_child("moe-crash", "train", argv, workdir, expect_rc=1,
                                  env={"DSTACK_TPU_TRAIN_CRASH_AT_STEP": "3"})
        resumed, out, points = run_child("moe-resume", "train", argv, workdir)
        if (crashed["losses"] != {s: ref[s] for s in (1, 2, 3)}
                or resumed["losses"] != {s: ref[s] for s in (3, 4)}
                or "resumed from checkpoint step 2" not in out):
            raise AssertionError(f"moe resume: crashed {crashed['losses']}, resumed"
                                 f" {resumed['losses']}, against {[ref[s] for s in (1, 2, 3, 4)]}")
        log(f"moe (d) {' '.join(argv[:-3])} ... --resume crashed at step 3 and resumed from the"
            f" step-2 checkpoint: steps 3-4 {[resumed['losses'][s] for s in (3, 4)]} bit-equal to"
            f" (a); checkpoints {checkpoint_marks(points, 'moe-resume')} [{card}]")

        # (e) the ep mesh: one NCCL rank.
        one = run_train_ranks("moe-ep1", ["--config", "moe_test", "--steps", "5", "--ep", "1"], 1,
                              workdir, timeout=300)[0][0]
        if one["losses"] != {s: ref[s] for s in range(1, 6)}:
            raise AssertionError(f"moe --ep 1 on one NCCL rank: losses {one['losses']} against"
                                 f" {[ref[s] for s in range(1, 6)]}")
        log(f"moe (e) --ep 1 on one NCCL rank under torchrun's environment: losses 1-5"
            f" bit-equal to (a) [{card}]")

        # Four processes sharing the card over gloo.
        cfg = moe_config(MOE_MESH_RUN["config"], MOE_MESH_RUN["layers"],
                         **MOE_MESH_RUN["overrides"])
        batches = moe_batches(cfg.vocab_size, MOE_MESH_RUN["batch"], MOE_MESH_RUN["seq"],
                              MOE_MESH_RUN["steps"], MOE_MESH_RUN["seed"])
        meshless = moe_steps(cfg, MOE_MESH_RUN["seed"], batches, torch.device("cuda"))
        plan = dict(backend="gloo", run=MOE_MESH_RUN, shapes=MOE_MESH_SHAPES)
        code = "import sys, chip_smoke; chip_smoke.moe_mesh_child(*sys.argv[1:])"
        ranks = run_ranks("moe-mesh-gloo", code, [json.dumps(plan)], 4, workdir, timeout=420)
        if "probe_error" in ranks[0][0]:
            log(f"moe mesh on one card: not run ({ranks[0][0]['probe_error']}); the CPU gloo"
                f" tests (tests/test_torch_moe_mesh.py) carry the check [{card}]")
        else:
            for name in MOE_MESH_SHAPES:
                got = [r[0][name] for r in ranks]
                gaps = [abs(a - b) / abs(b) for a, b in zip(got[0]["losses"], meshless["losses"])]
                if any(g["losses"] != got[0]["losses"] for g in got) or max(gaps) > MOE_TOL:
                    raise AssertionError(f"moe mesh {name}: losses {[g['losses'] for g in got]}"
                                         f" against meshless {meshless['losses']}")
                log(f"moe (e) {name}, four gloo processes on one card, fp32 moe_test seq"
                    f" {MOE_MESH_RUN['seq']}: losses {got[0]['losses']} against meshless"
                    f" {meshless['losses']} (relative gaps {[f'{g:.1e}' for g in gaps]}), peak"
                    f" {max(g['peak_gb'] for g in got):.2f} GB a rank [{card}]")

        # With four cards, Mixtral width over NCCL.
        cards = torch.cuda.device_count()
        if cards < 4:
            log(f"moe multi-card: not run ({cards} card visible) [{card}]")
            return launches
        plan = dict(backend="nccl", run=MOE_CARDS_RUN, shapes={"ep4": MOE_MESH_SHAPES["ep4"]},
                    time_a2a=True)
        ranks = run_ranks("moe-cards", code, [json.dumps(plan)], 4, workdir, timeout=600)
        got = [r[0]["ep4"] for r in ranks]
        if any(g["losses"] != got[0]["losses"] for g in got) or not all(
                np.isfinite(got[0]["losses"])):
            raise AssertionError(f"moe on four cards: losses {[g['losses'] for g in got]}")
        log(f"moe (e) mixtral width, {MIXTRAL_LAYERS} layers, --ep 4 on four cards over NCCL,"
            f" batch {MOE_CARDS_RUN['batch']} x {MOE_CARDS_RUN['seq']}: losses"
            f" {got[0]['losses']}, step times {[round(t * 1e3, 1) for t in got[0]['step_s']]} ms,"
            f" the dispatch all-to-all {got[0]['a2a_ms']:.3f} ms for"
            f" {got[0]['a2a_bytes'] / 1e6:.1f} MB a rank, peak"
            f" {max(g['peak_gb'] for g in got):.2f} GB a rank [{card}]")
        return launches
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


# -- phase 16: the mesh axes -------------------------------------------------------
#
# llama3_1b at full width and DEPTH_CUTS' depth (fp32 masters, bf16
# activations, remat full), batch 2 x 8192: GPipe over pp 2 (2 microbatches, the flash
# kernels in every stage) and the ring over sp 2 (blockwise, the
# reference's ring core), each as two processes sharing the card over gloo;
# then fp32 identity at 2 layers, seq 1024. MoE under tp: fp32 Mixtral
# width at 1 layer over ep 1 x tp 2 and moe_test over ep 2 x tp 2.
AXES_RUN = dict(config="llama3_1b", layers=DEPTH_CUTS["llama3_1b"], batch=2, seq=8192,
                seed=16)
AXES_SMALL = dict(layers=2, seq=1024)
PP_MICRO = 2
# bf16 runs whose sums round in other orders: the loss relative, each
# leaf's gradient norm relative.
AXES_LOSS_RTOL, AXES_NORM_RTOL = 1e-3, 1e-2
AXES_TOL = 1e-5
AXES_MOE_RUN = dict(config="mixtral_8x7b", layers=1,
                    overrides=dict(dtype="float32", param_dtype="float32", attn_impl="flash"),
                    batch=2, seq=1024, steps=2, seed=3)
AXES_MOE_SHAPES = {"ep1xtp2": dict(dp=1, fsdp=1, ep=1, tp=2, sp=1)}
AXES_MOE_TEST_SHAPES = {"ep2xtp2": dict(dp=1, fsdp=1, ep=2, tp=2, sp=1)}
# With four cards, over NCCL: pp 4 at batch 4 x 8192 (4 microbatches), sp 4
# at seq 32768.
AXES_CARDS = dict(pp=4, pp_batch=4, pp_micro=4, sp=4, sp_seq=32768, sp_batch=2)


def axes_config(layers: int = AXES_RUN["layers"], **overrides):
    """llama3_1b for phase 16: flash, remat full, at ``layers`` layers, with
    ``overrides``."""
    from dstack_tpu_torch.workloads.config import get_config

    kw = {"attn_impl": "flash", "remat": True, "remat_policy": "full", **overrides}
    return get_config(AXES_RUN["config"], n_layers=layers, **kw)


def axes_batch(vocab: int, batch: int, seq: int, seed: int):
    """One seeded global batch (numpy tokens, targets)."""
    from dstack_tpu_torch.workloads import data

    return next(data.synthetic_batches(vocab, batch, seq, seed=seed))


def pp_value_and_grad(cfg, batch, seq, device, mesh=None, n_micro: int = PP_MICRO,
                      iters: int = 2, save: str = "") -> dict:
    """Loss and gradients of the seeded llama3_1b tree on one seeded batch:
    meshless (``model.loss_fn``) or on a pipeline mesh (this rank's stage,
    ``pipeline.pipelined_loss_fn``), ``iters`` times; the last run's loss,
    each leaf's gradient norm (a layer leaf's by stage: [L/pp] rows each),
    its time and the flash launches, the peak memory. ``save``: a file for
    the gradients (this rank's pieces)."""
    import torch

    from dstack_tpu_torch.workloads import data, model, pipeline
    from dstack_tpu_torch.workloads.kernels import flash

    torch.cuda.reset_peak_memory_stats(device)
    params = model.init_params(cfg, torch.Generator(device=device).manual_seed(AXES_RUN["seed"]),
                               device)
    pp = mesh.shape["pp"] if mesh is not None else 2
    if mesh is not None:
        params = {k: v.clone() for k, v in pipeline.shard_params_pp(params, mesh).items()}
        torch.cuda.empty_cache()
    params = {k: v.requires_grad_(True) for k, v in params.items()}
    tokens, targets = axes_batch(cfg.vocab_size, batch, seq, AXES_RUN["seed"])
    if mesh is not None:
        rows = data.rank_rows(batch, n_micro, mesh.index("dp"), mesh.shape["dp"])
        tokens, targets = tokens[rows], targets[rows]
    tokens, targets = (torch.from_numpy(a).to(device) for a in (tokens, targets))
    for _ in range(iters):
        flash.reset_launches()
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        if mesh is None:
            loss = model.loss_fn(params, tokens, targets, cfg)
        else:
            loss = pipeline.pipelined_loss_fn(params, tokens, targets, cfg, mesh, n_micro)
        grads = torch.autograd.grad(loss, list(params.values()))
        torch.cuda.synchronize(device)
        ms = (time.perf_counter() - t0) * 1e3
    grads = dict(zip(params, grads))
    norms = {}
    for k, g in grads.items():
        if k in pipeline.LAYER_KEYS and mesh is None:
            norms[k] = [float(c.float().norm()) for c in g.chunk(pp)]
        elif k in pipeline.LAYER_KEYS:
            norms[k] = {mesh.index("pp"): float(g.float().norm())}
        else:
            norms[k] = float(g.float().norm())
    if save:
        torch.save({k: g.cpu() for k, g in grads.items()}, save)
    return dict(loss=loss.item(), norms=norms, ms=ms, launches=default_launches(flash),
                peak_gb=torch.cuda.max_memory_allocated(device) / 1e9)


def sp_train(cfg, batch, seq, steps, device, mesh=None) -> dict:
    """``train.train`` of ``cfg`` from seed 0 on the synthetic feed: each
    step's loss and wall time, the peak memory."""
    import torch

    from dstack_tpu_torch.workloads import train

    torch.cuda.reset_peak_memory_stats(device)
    losses, times, last = [], [], [time.perf_counter()]

    def on_step(step, loss):
        torch.cuda.synchronize(device)
        now = time.perf_counter()
        losses.append(float(loss))
        times.append(now - last[0])
        last[0] = now

    train.train(cfg, steps=steps, batch=batch, seq=seq, device=device, prefetch=1,
                on_step=on_step, mesh=mesh)
    return dict(losses=losses, step_s=times,
                peak_gb=torch.cuda.max_memory_allocated(device) / 1e9)


def axes_reference_child(plan_json: str, report: str) -> None:
    """The meshless runs phase 16 holds the meshes against, in a process of
    its own on the card: the pipelined runs' loss and gradients, the ring
    runs' train.train losses, the MoE steps."""
    import torch

    from dstack_tpu_torch.workloads.kernels import platform

    plan = json.loads(plan_json)
    platform.set_reference_matmul_precision()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = {}
    try:
        out["pp"] = pp_value_and_grad(axes_config(), AXES_RUN["batch"], AXES_RUN["seq"], device)
        torch.cuda.empty_cache()
        out["pp_fp32"] = pp_value_and_grad(
            axes_config(AXES_SMALL["layers"], dtype="float32"), AXES_RUN["batch"],
            AXES_SMALL["seq"], device, iters=1, save=plan["pp_fp32_grads"])
        torch.cuda.empty_cache()
        out["sp"] = sp_train(axes_config(attn_impl="blockwise"), AXES_RUN["batch"],
                             AXES_RUN["seq"], 2, device)
        torch.cuda.empty_cache()
        out["sp_fp32"] = sp_train(axes_config(AXES_SMALL["layers"], attn_impl="blockwise",
                                              dtype="float32"),
                                  AXES_RUN["batch"], AXES_SMALL["seq"], 3, device)
        torch.cuda.empty_cache()
        for name, run in (("moe", AXES_MOE_RUN), ("moe_test", MOE_MESH_RUN)):
            cfg = moe_config(run["config"], run["layers"], **run["overrides"])
            batches = moe_batches(cfg.vocab_size, run["batch"], run["seq"], run["steps"],
                                  run["seed"])
            out[name] = moe_steps(cfg, run["seed"], batches, device)
            torch.cuda.empty_cache()
    finally:
        with open(report, "w", encoding="utf-8") as f:
            json.dump(out, f)


def _axes_group(plan: dict):
    """Join the plan's process group under torchrun's environment: gloo
    with every rank on cuda:0 (processes sharing one card), or NCCL one
    card a rank. Returns this rank's device."""
    import os

    import torch
    import torch.distributed as dist

    from dstack_tpu_torch.workloads import sharding

    if plan["backend"] == "gloo":
        os.environ["LOCAL_RANK"] = "0"
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        dist.init_process_group("gloo", rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]),
                                timeout=sharding.COLLECTIVE_TIMEOUT)
        return device
    return sharding.init_distributed(torch.device("cuda"))


def axes_mesh_child(plan_json: str, report: str) -> None:
    """One rank of phase 16's meshes: each part of the plan in turn (GPipe,
    the ring, MoE under tp, at the plan's sizes); writes the results as
    JSON."""
    import torch
    import torch.distributed as dist

    from dstack_tpu_torch.workloads import pipeline, sharding
    from dstack_tpu_torch.workloads.kernels import platform

    plan = json.loads(plan_json)
    platform.set_reference_matmul_precision()
    device = _axes_group(plan)
    world = dist.get_world_size()
    out = {}
    try:
        for part in plan["parts"]:
            torch.cuda.empty_cache()
            if part == "pp":
                mesh = pipeline.make_pp_mesh(dp=1, pp=world).connect(device)
                out[part] = pp_value_and_grad(axes_config(), plan.get("pp_batch", AXES_RUN["batch"]),
                                              AXES_RUN["seq"], device, mesh,
                                              plan.get("pp_micro", PP_MICRO))
            elif part == "pp_fp32":
                mesh = pipeline.make_pp_mesh(dp=1, pp=world).connect(device)
                save = plan["pp_fp32_grads"].format(rank=dist.get_rank())
                out[part] = pp_value_and_grad(
                    axes_config(AXES_SMALL["layers"], dtype="float32"), AXES_RUN["batch"],
                    AXES_SMALL["seq"], device, mesh, iters=1, save=save)
            elif part in ("sp", "sp_fp32"):
                mesh = sharding.make_mesh(fsdp=1, sp=world).connect(device)
                small = part == "sp_fp32"
                cfg = axes_config(AXES_SMALL["layers"] if small else AXES_RUN["layers"],
                                  attn_impl="blockwise",
                                  **({"dtype": "float32"} if small else {}))
                out[part] = sp_train(cfg, plan.get("sp_batch", AXES_RUN["batch"]),
                                     AXES_SMALL["seq"] if small else plan.get(
                                         "sp_seq", AXES_RUN["seq"]),
                                     3 if small else 2, device, mesh)
            else:  # MoE under tp
                run = AXES_MOE_RUN if part == "moe" else MOE_MESH_RUN
                shapes = AXES_MOE_SHAPES if part == "moe" else AXES_MOE_TEST_SHAPES
                cfg = moe_config(run["config"], run["layers"], **run["overrides"])
                batches = moe_batches(cfg.vocab_size, run["batch"], run["seq"], run["steps"],
                                      run["seed"])
                for name, shape in shapes.items():
                    mesh = sharding.make_moe_mesh(**shape).connect(device)
                    out[name] = moe_steps(cfg, run["seed"], batches, device, mesh)
    finally:
        with open(report, "w", encoding="utf-8") as f:
            json.dump(out, f)
        dist.destroy_process_group()


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def check_pp(label: str, got: list, ref: dict, rtol: float, norm_rtol: float) -> float:
    """Every rank's pipelined loss within ``rtol`` of meshless, and each
    leaf's gradient norm (a layer leaf's by stage) within ``norm_rtol``;
    returns the largest relative gap of a norm."""
    worst = 0.0
    for rank, g in enumerate(got):
        if _rel(g["loss"], ref["loss"]) > rtol:
            raise AssertionError(f"{label} rank {rank}: loss {g['loss']!r} against meshless"
                                 f" {ref['loss']!r}")
        for k, n in g["norms"].items():
            if isinstance(n, dict):
                (stage, n), = ((int(s), v) for s, v in n.items())
                want = ref["norms"][k][stage]
            else:
                want = ref["norms"][k]
            worst = max(worst, _rel(n, want))
            if _rel(n, want) > norm_rtol:
                raise AssertionError(f"{label} rank {rank}: {k} gradient norm {n!r} against"
                                     f" meshless {want!r}")
    return worst


def compare_saved_grads(label: str, paths: list, ref_path: str, specs: dict, mesh) -> float:
    """Each rank's saved gradient pieces against the same pieces of the
    meshless gradients: the largest difference over each leaf's largest
    |value| must stay within AXES_TOL."""
    import torch

    from dstack_tpu_torch.workloads import sharding

    ref = torch.load(ref_path)
    worst = 0.0
    for rank, path in enumerate(paths):
        for k, g in torch.load(path).items():
            want = ref[k][sharding.local_slices(specs[k], ref[k].shape, mesh, rank)]
            err = float((g - want).abs().max() / ref[k].abs().max())
            worst = max(worst, err)
            if err > AXES_TOL:
                raise AssertionError(f"{label} rank {rank}: {k} gradient {err:.2e} of its"
                                     f" largest value from meshless")
    return worst


def phase_mesh_axes(card: str) -> dict:
    """Phase 16: pp, sp and MoE under tp, and the port's dry run. Returns
    the flash launches of the GPipe runs."""
    import os
    import shutil
    import tempfile

    import torch

    from dstack_tpu_torch.workloads import pipeline, sharding

    workdir = tempfile.mkdtemp(prefix="chip-smoke-axes-")
    code = "import sys, chip_smoke; chip_smoke.axes_mesh_child(*sys.argv[1:])"
    dryrun = None
    try:
        t0 = time.monotonic()
        grads = os.path.join(workdir, "pp-fp32-{rank}.pt")
        ref_grads = os.path.join(workdir, "pp-fp32-meshless.pt")
        ref, _, _ = run_ranks_one("axes-reference", "import sys, chip_smoke;"
                                  " chip_smoke.axes_reference_child(*sys.argv[1:])",
                                  json.dumps(dict(pp_fp32_grads=ref_grads)), workdir, 600)
        # (d) runs beside the gloo worlds, whose times are correctness only;
        # the meshless times above ran alone.
        dryrun = start_dryrun(workdir)
        plan = dict(backend="gloo", parts=["pp", "pp_fp32", "sp", "sp_fp32", "moe"],
                    pp_fp32_grads=grads)
        ranks = [r[0] for r in run_ranks("axes-gloo2", code, [json.dumps(plan)], 2, workdir,
                                         timeout=900)]
        cfg = axes_config()
        layers = cfg.n_layers // 2
        # (a) GPipe: every rank's loss and gradient norms against meshless,
        # and its flash launches: each of its layers runs the forward twice
        # a microbatch (and again under remat), dq and dk/dv once.
        pp = [r["pp"] for r in ranks]
        worst = check_pp("pp2", pp, ref["pp"], AXES_LOSS_RTOL, AXES_NORM_RTOL)
        want = {"flash_fwd": layers * PP_MICRO * 2, "flash_bwd_dq": layers * PP_MICRO,
                "flash_bwd_dkv": layers * PP_MICRO}
        for rank, g in enumerate(pp):
            if g["launches"] != want:
                raise AssertionError(f"pp2 rank {rank}: flash launches {g['launches']},"
                                     f" want {want}")
        log(f"mesh axes (a) GPipe llama3_1b full width, {cfg.n_layers} layers (bf16"
            f" activations, fp32 masters, remat full, flash), batch {AXES_RUN['batch']} x {AXES_RUN['seq']},"
            f" pp 2 as two gloo processes on one card, {PP_MICRO} microbatches: loss"
            f" {pp[0]['loss']!r} against meshless {ref['pp']['loss']!r} (relative"
            f" {_rel(pp[0]['loss'], ref['pp']['loss']):.2e}), gradient norms within"
            f" {worst:.2e}; flash launches a rank {pp[0]['launches']} (exact: {layers} layers x"
            f" {PP_MICRO} microbatches); forward and backward {pp[0]['ms']:.1f} / {pp[1]['ms']:.1f}"
            f" ms a rank (correctness only: gloo's hops are host copies, and both ranks share"
            f" the card) against meshless {ref['pp']['ms']:.1f} ms, peak"
            f" {pp[0]['peak_gb']:.2f} / {pp[1]['peak_gb']:.2f} GB a rank against meshless"
            f" {ref['pp']['peak_gb']:.2f} GB [{card}]")
        small = [r["pp_fp32"] for r in ranks]
        mesh = pipeline.make_pp_mesh(dp=1, pp=2, world=2)
        err = compare_saved_grads("pp2 fp32", [grads.format(rank=r) for r in range(2)],
                                  ref_grads, pipeline.stage_params_spec(), mesh)
        for g in small:
            if _rel(g["loss"], ref["pp_fp32"]["loss"]) > AXES_TOL:
                raise AssertionError(f"pp2 fp32: loss {g['loss']!r} against"
                                     f" {ref['pp_fp32']['loss']!r}")
        log(f"mesh axes (a) fp32 llama3_1b width, {AXES_SMALL['layers']} layers, seq"
            f" {AXES_SMALL['seq']}, pp 2: loss {small[0]['loss']!r} against meshless"
            f" {ref['pp_fp32']['loss']!r}, every gradient piece within {err:.2e} of its leaf's"
            f" largest value [{card}]")
        # (b) the ring over sp 2.
        for part, rtol in (("sp", AXES_LOSS_RTOL), ("sp_fp32", AXES_TOL)):
            got = [r[part] for r in ranks]
            gaps = [_rel(a, b) for a, b in zip(got[0]["losses"], ref[part]["losses"])]
            if any(g["losses"] != got[0]["losses"] for g in got) or max(gaps) > rtol:
                raise AssertionError(f"{part}: losses {[g['losses'] for g in got]} against"
                                     f" meshless {ref[part]['losses']}")
            what = (f"llama3_1b full width, {cfg.n_layers} layers, batch {AXES_RUN['batch']} x"
                    f" {AXES_RUN['seq']}, 2 steps" if part == "sp" else
                    f"fp32 llama3_1b width, {AXES_SMALL['layers']} layers, seq"
                    f" {AXES_SMALL['seq']}, 3 steps")
            log(f"mesh axes (b) ring attention, sp 2 as two gloo processes on one card,"
                f" blockwise, {what} through train.train: losses {got[0]['losses']} against"
                f" meshless {ref[part]['losses']} (relative gaps {[f'{g:.1e}' for g in gaps]});"
                f" step times {[round(s * 1e3, 1) for s in got[0]['step_s']]} ms (correctness"
                f" only) against meshless {[round(s * 1e3, 1) for s in ref[part]['step_s']]},"
                f" peak {max(g['peak_gb'] for g in got):.2f} GB a rank against"
                f" {ref[part]['peak_gb']:.2f} GB [{card}]")
        # (c) MoE under tp.
        check_moe_tp("ep1xtp2", [r["ep1xtp2"] for r in ranks], ref["moe"],
                      f"fp32 mixtral width, {AXES_MOE_RUN['layers']} layer, seq"
                      f" {AXES_MOE_RUN['seq']}, two gloo processes on one card", card)
        four = [r[0] for r in run_ranks("axes-gloo4", code, [json.dumps(dict(
            backend="gloo", parts=["moe_test"]))], 4, workdir, timeout=300)]
        check_moe_tp("ep2xtp2", [r["ep2xtp2"] for r in four], ref["moe_test"],
                     f"fp32 moe_test, seq {MOE_MESH_RUN['seq']}, four gloo processes on one card",
                     card)
        # (d) the dry run and the entry point.
        finish_dryrun(dryrun, card)
        launches = {name: sum(g["launches"][name] for g in pp) for name in want}
        # (e) four cards.
        cards = torch.cuda.device_count()
        if cards < 4:
            log(f"mesh axes multi-card: not run ({cards} card visible) [{card}]")
        else:
            axes_cards(card, workdir)
        log(f"mesh axes: {time.monotonic() - t0:.1f} s [{card}]")
        return launches
    finally:
        stop_dryrun(dryrun)
        shutil.rmtree(workdir, ignore_errors=True)


def check_moe_tp(name: str, got: list, ref: dict, what: str, card: str) -> None:
    gaps = [_rel(a, b) for a, b in zip(got[0]["losses"], ref["losses"])]
    if any(g["losses"] != got[0]["losses"] for g in got) or max(gaps) > AXES_TOL:
        raise AssertionError(f"moe {name}: losses {[g['losses'] for g in got]} against meshless"
                             f" {ref['losses']}")
    log(f"mesh axes (c) MoE {name}, {what}: losses {got[0]['losses']} against meshless"
        f" {ref['losses']} (relative gaps {[f'{g:.1e}' for g in gaps]}), grad norms"
        f" {got[0]['norms']} against {ref['norms']}, peak {max(g['peak_gb'] for g in got):.2f}"
        f" GB a rank [{card}]")


def run_ranks_one(label: str, code: str, arg: str, workdir: str, timeout: float):
    """``code`` in one child process (no process group): its report."""
    import os

    report = os.path.join(workdir, f"{label}.json")
    proc = subprocess.run([sys.executable, "-c", code, arg, report],
                          cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                          text=True, timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"{label}: exit {proc.returncode}:\n{proc.stderr[-4000:]}")
    with open(report, encoding="utf-8") as f:
        return json.load(f), proc.stdout, proc.stderr


def start_dryrun(workdir: str):
    """Start ``python -m dstack_tpu_torch.dryrun 16`` on the card (16 ranks
    sharing it over gloo, 8 and 4 beside them); its output goes to files
    under ``workdir``."""
    root = os.path.dirname(os.path.abspath(__file__))
    out = open(os.path.join(workdir, "dryrun.out"), "w+", encoding="utf-8")
    err = open(os.path.join(workdir, "dryrun.err"), "w+", encoding="utf-8")
    # Its own process group (setsid): stop_dryrun kills the run with its ranks.
    proc = subprocess.Popen([sys.executable, "-m", "dstack_tpu_torch.dryrun", "16"], cwd=root,
                            stdout=out, stderr=err, text=True, start_new_session=True)
    return proc, out, err, time.monotonic()


def stop_dryrun(started) -> None:
    """Kill ``start_dryrun``'s run and its ranks, if still running."""
    import signal

    if started is not None and started[0].poll() is None:
        os.killpg(started[0].pid, signal.SIGKILL)
        started[0].wait()


def finish_dryrun(started, card: str, timeout: float = 600.0) -> None:
    """Wait for ``start_dryrun``'s run: JAX's four lines at 16 devices with
    finite positive losses, and the entry point's forward."""
    import re

    proc, out, err, t0 = started
    try:
        proc.wait(timeout=max(1.0, timeout - (time.monotonic() - t0)))
    except subprocess.TimeoutExpired:
        stop_dryrun(started)
        raise AssertionError(f"dryrun 16: not done in {timeout:.0f} s") from None
    wall = time.monotonic() - t0
    out.seek(0)
    err.seek(0)
    stdout, stderr = out.read(), err.read()
    out.close()
    err.close()
    if proc.returncode != 0:
        raise AssertionError(f"dryrun 16: exit {proc.returncode}:\n{stdout[-3000:]}"
                             f"\n{stderr[-3000:]}")
    lines = stdout.strip().splitlines()
    want = ["dryrun_multichip ok: mesh dp=2 fsdp=2 tp=2 sp=2, loss=",
            "dryrun_multichip multislice ok: 4 slices x 4 devices (fsdp=2 tp=2), loss=",
            "dryrun_multichip MoE ok: ep=2 tp=2 dp=2 (4 experts top-2), loss=",
            "dryrun_multichip pipeline ok: pp=2 dp=2 (GPipe), loss="]
    if len(lines) != 5 or any(not line.startswith(w) for line, w in zip(lines, want)):
        raise AssertionError(f"dryrun 16: printed {lines}")
    for line in lines[:4]:
        loss = float(line.rsplit("loss=", 1)[1])
        if not (np.isfinite(loss) and loss > 0):
            raise AssertionError(f"dryrun 16: {line}")
    if not re.fullmatch(r"entry ok: \(2, 128, 4096\) float32", lines[4]):
        raise AssertionError(f"dryrun 16: {lines[4]}")
    for line in lines:
        log(f"  [dryrun 16] {line}")
    log(f"mesh axes (d) python -m dstack_tpu_torch.dryrun 16 on the card: 16, 8 and 4 gloo"
        f" processes sharing it, beside (a)-(c)'s gloo worlds, {wall:.1f} s [{card}]")


def axes_cards(card: str, workdir: str) -> None:
    """(e) With four cards over NCCL: GPipe at pp 4 (batch 4 x 8192, 4
    microbatches) and the ring at sp 4 (seq 32768): times and peaks a rank."""
    code = "import sys, chip_smoke; chip_smoke.axes_mesh_child(*sys.argv[1:])"
    plan = dict(backend="nccl", parts=["pp", "sp"], pp_batch=AXES_CARDS["pp_batch"],
                pp_micro=AXES_CARDS["pp_micro"], sp_seq=AXES_CARDS["sp_seq"],
                sp_batch=AXES_CARDS["sp_batch"])
    ranks = [r[0] for r in run_ranks("axes-cards", code, [json.dumps(plan)], 4, workdir,
                                     timeout=900)]
    pp, sp = [r["pp"] for r in ranks], [r["sp"] for r in ranks]
    if any(abs(g["loss"] - pp[0]["loss"]) > 0 for g in pp) or not np.isfinite(pp[0]["loss"]):
        raise AssertionError(f"pp 4 on four cards: losses {[g['loss'] for g in pp]}")
    if any(g["losses"] != sp[0]["losses"] for g in sp) or not all(np.isfinite(sp[0]["losses"])):
        raise AssertionError(f"sp 4 on four cards: losses {[g['losses'] for g in sp]}")
    log(f"mesh axes (e) GPipe pp 4 on four cards over NCCL, llama3_1b, batch"
        f" {AXES_CARDS['pp_batch']} x {AXES_RUN['seq']}, {AXES_CARDS['pp_micro']} microbatches:"
        f" loss {pp[0]['loss']!r}, forward and backward {[round(g['ms'], 1) for g in pp]} ms by"
        f" rank, peak {[round(g['peak_gb'], 2) for g in pp]} GB [{card}]")
    log(f"mesh axes (e) ring sp 4 on four cards over NCCL, llama3_1b blockwise, batch"
        f" {AXES_CARDS['sp_batch']} x {AXES_CARDS['sp_seq']}: losses {sp[0]['losses']}, step"
        f" times {[round(s * 1e3, 1) for s in sp[0]['step_s']]} ms, peak"
        f" {max(g['peak_gb'] for g in sp):.2f} GB a rank [{card}]")


# -- phase 17: the last paths --------------------------------------------------

# A 64-wide head dim checked at every menu pair beside llama3_1b's 128:
# (B, H, Kh, D, T).
TILES_D64 = (2, 8, 4, 64, 2048)
TILES_WINDOW = 4096


def menu_tiles(blocks) -> dict:
    """{wrapper suffix: (rows, keys)} of the tensor-core kernels at a menu
    pair, from kernels/flash.py's TILE_MENU."""
    from dstack_tpu_torch.workloads.kernels import flash

    tiles = flash.TILE_MENU[blocks]
    return {"fwd": tiles.fwd, "bwd_dq": tiles.dq, "bwd_dkv": tiles.dkv}


def tiles_run(kind: str, x, docs, window, blocks) -> dict:
    """{wrapper: outputs} of the flash or splash kernels at a menu pair (or
    their plain versions with ``blocks`` None), the backward on the plain
    forward's lse and delta."""
    from dstack_tpu_torch.workloads.kernels import flash, splash

    q3, k3, v3, do3 = x
    if kind == "flash":
        ro, rlse = flash.flash_fwd_plain(q3, k3, v3, True)
        extra = (True,)
        fns = (flash.flash_fwd, flash.flash_bwd_dq, flash.flash_bwd_dkv)
        plains = (flash.flash_fwd_plain, flash.flash_bwd_dq_plain, flash.flash_bwd_dkv_plain)
        fwd_args = (q3, k3, v3, True)
    else:
        ro, rlse = splash.splash_fwd_plain(q3, k3, v3, docs, docs, True, window)
        extra = (docs, docs, True, window)
        fns = (splash.splash_fwd, splash.splash_bwd_dq, splash.splash_bwd_dkv)
        plains = (splash.splash_fwd_plain, splash.splash_bwd_dq_plain,
                  splash.splash_bwd_dkv_plain)
        fwd_args = (q3, k3, v3, docs, docs, True, window)
    args = (q3, k3, v3, do3, rlse, (do3 * ro).sum(-1), *extra)
    names = [f"{kind}_{s}" for s in ("fwd", "bwd_dq", "bwd_dkv")]
    if blocks is None:
        outs = [(ro, rlse), (plains[1](*args),), plains[2](*args)]
    else:
        outs = [fns[0](*fwd_args, blocks), (fns[1](*args, blocks),), fns[2](*args, blocks)]
    return dict(zip(names, outs))


def tiles_compare(kind: str, label: str, x, docs, window, report: dict) -> None:
    """Every menu pair's kernels against the plain versions (computed once)
    at FLASH_TOL; the largest error per (wrapper, pair) into ``report``."""
    import torch

    from dstack_tpu_torch.workloads.kernels import flash

    ref = tiles_run(kind, x, docs, window, None)
    for blocks in flash.TILE_MENU:
        got = tiles_run(kind, x, docs, window, blocks)
        torch.cuda.synchronize()
        line = []
        for name, outs in got.items():
            err = 0.0
            for g, r in zip(outs, ref[name]):
                if not bool(torch.isfinite(g).all()):
                    raise AssertionError(f"{name} {label} at {blocks}: non-finite output")
                torch.testing.assert_close(g, r, atol=FLASH_TOL, rtol=0)
                err = max(err, float((g - r).abs().max()))
            entry = report.setdefault(name, {}).setdefault("%dx%d" % blocks, {"max_abs_err": 0.0})
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            line.append(f"{name.split('_', 1)[1]} {err:.3e}")
        log(f"tiles {kind} {label} window={window} docs={'yes' if docs is not None else 'no'}"
            f" at {blocks[0]}x{blocks[1]}: max_abs_err {', '.join(line)} (atol {FLASH_TOL:g}) ok")
        del got
    del ref
    torch.cuda.empty_cache()


def tiles_timing(kind: str, x, window, report: dict) -> None:
    """CUDA-event medians of each kernel at every menu pair (W 4096 for
    splash), into ``report``; the default pair's is the earlier phases'
    reading of today's tiles."""
    from dstack_tpu_torch.workloads.kernels import flash, splash

    q3, k3, v3, do3 = x
    mod = flash if kind == "flash" else splash
    extra = (True,) if kind == "flash" else (None, None, True, window)
    fwd_args = (q3, k3, v3, *extra)
    o, lse = getattr(mod, f"{kind}_fwd")(*fwd_args)
    args = (q3, k3, v3, do3.bfloat16().float(), lse, (do3 * o).sum(-1), *extra)
    for blocks in flash.TILE_MENU:
        line = []
        for suffix, fn, fn_args in (("fwd", f"{kind}_fwd", fwd_args),
                                    ("bwd_dq", f"{kind}_bwd_dq", args),
                                    ("bwd_dkv", f"{kind}_bwd_dkv", args)):
            ms = time_ms(lambda: getattr(mod, fn)(*fn_args, blocks), iters=10)
            report[f"{kind}_{suffix}"]["%dx%d" % blocks]["ms"] = ms
            line.append(f"{suffix} {ms:.4f} ms")
        log(f"tiles {kind} timing at {blocks[0]}x{blocks[1]} (llama3_1b heads, T 8192"
            f"{', window %d' % window if kind == 'splash' else ''}, do of bf16 values):"
            f" {', '.join(line)}")


def phase_autotune(card: str) -> dict:
    """17 (b): ``train.main`` with the training example's flags and
    --autotune (llama3_1b, seq 8192, batch 8, 3 steps, as phase 10) in a
    fresh autotune directory: JAX's line once, the cache file, every splash
    launch exact and at the pair it ran (the sweep's and the winner's), the
    sweep's seconds, losses finite and falling; then one step without
    --autotune that reads the cache and sweeps nothing."""
    import contextlib
    import io
    import os
    import shutil
    import tempfile

    import torch

    from dstack_tpu_torch.workloads import train
    from dstack_tpu_torch.workloads.kernels import autotune, flash, splash

    tune_dir = tempfile.mkdtemp(prefix="autotune-")
    saved_dir = os.environ.get(autotune.ENV_DIR)
    os.environ[autotune.ENV_DIR] = tune_dir
    autotune._memo = None
    inner_train, inner_tune = train.train, autotune.tune
    losses, reports = [], []

    def recording(*args, **kwargs):
        return inner_train(*args, on_step=lambda step, loss: losses.append(loss), **kwargs)

    def timed_tune(*args, **kwargs):
        t0 = time.monotonic()
        report = inner_tune(*args, **kwargs)
        reports.append(dict(report, seconds=time.monotonic() - t0))
        return report

    real_stdout = sys.stdout

    class Tee(io.StringIO):
        def write(self, text):
            real_stdout.write(text)
            return super().write(text)

    runs = {}
    train.train, autotune.tune = recording, timed_tune
    try:
        for label, argv in (("--autotune", SPLASH_MAIN_ARGV + ["--autotune"]),
                            ("cached", SPLASH_MAIN_ARGV[:-2] + ["--steps", "1"])):
            losses.clear()
            splash.reset_launches()
            flash.reset_launches()
            out = Tee()
            with contextlib.redirect_stdout(out):
                stats = train.main(argv)
            torch.cuda.synchronize()
            runs[label] = dict(losses=list(losses), stats=stats, stdout=out.getvalue(),
                               pairs={n: dict(c) for n, c in splash.pair_launches.items()},
                               flash=dict(flash.launches))
    finally:
        train.train, autotune.tune = inner_train, inner_tune
        if saved_dir is None:
            os.environ.pop(autotune.ENV_DIR, None)
        else:
            os.environ[autotune.ENV_DIR] = saved_dir
        autotune._memo = None
    with open(os.path.join(tune_dir, autotune.CACHE_FILE), encoding="utf-8") as f:
        cache = json.load(f)
    shutil.rmtree(tune_dir, ignore_errors=True)
    if len(reports) != 1:
        raise AssertionError(f"--autotune swept {len(reports)} times over the two runs")
    report = reports[0]
    winner = tuple(report["blocks"])
    line = (f"autotune: splash gen=sm90 head_dim=128 seq=8192 -> blocks={winner}")
    key = "splash|sm90|128|8192"
    if line not in runs["--autotune"]["stdout"] or cache != {key: list(winner)}:
        raise AssertionError(f"--autotune: no line {line!r}, or the cache {cache}")
    if set(report["sweep"]) != {"%dx%d" % p for p in flash.TILE_MENU}:
        raise AssertionError(f"the sweep timed {sorted(report['sweep'])}")
    layers, micro = get_layers("llama3_1b"), 4
    sweep_calls = 1 + 3  # autotune._seconds: one warm-up call, 3 timed (tune's repeats)
    for label, steps, swept in (("--autotune", 3, True), ("cached", 1, False)):
        run = runs[label]
        calls = layers * micro * steps
        for name, per in (("splash_fwd", 2 * calls), ("splash_bwd_dq", calls),
                          ("splash_bwd_dkv", calls)):
            want = {p: (sweep_calls if swept else 0) + (per if p == winner else 0)
                    for p in flash.TILE_MENU}
            want = {p: n for p, n in want.items() if n}
            if run["pairs"][name] != want or any(run["flash"].values()):
                raise AssertionError(f"{label}: {name} launches by pair {run['pairs'][name]}"
                                     f" != {want}; flash {run['flash']}")
        got = run["losses"]
        if len(got) != steps or not all(np.isfinite(got)):
            raise AssertionError(f"{label}: losses {got}")
    if not runs["--autotune"]["losses"][-1] < runs["--autotune"]["losses"][0]:
        raise AssertionError(f"--autotune: loss did not fall: {runs['--autotune']['losses']}")
    sweep = ", ".join(f"{k} {v * 1e3:.2f} ms" for k, v in report["sweep"].items())
    log(f"autotune (train.main {' '.join(SPLASH_MAIN_ARGV)} --autotune): sweep {sweep};"
        f" winner {winner}; the sweep {report['seconds']:.2f} s; losses"
        f" {[round(x, 4) for x in runs['--autotune']['losses']]}, step p50"
        f" {runs['--autotune']['stats']['p50_s'] * 1e3:.1f} ms (phase 10 without --autotune:"
        f" {MEASURED.get('splash_main_p50_s', float('nan')) * 1e3:.1f} ms); the cached run's"
        f" step {runs['cached']['losses']} at {winner}, no sweep; splash launches by pair"
        f" {runs['--autotune']['pairs']} [{card}]")
    MEASURED["autotune_winner"] = winner
    pairs = {}
    for run in runs.values():
        for name, counts in run["pairs"].items():
            for p, n in counts.items():
                key = "%dx%d" % p
                pairs.setdefault(name, {})[key] = pairs.get(name, {}).get(key, 0) + n
    return pairs


def get_layers(name: str) -> int:
    from dstack_tpu_torch.workloads.config import get_config

    return get_config(name).n_layers


SAVE_PROJ_POLICIES = ("full", "dots", "save_proj")


def phase_save_proj(card: str) -> dict:
    """17 (c): llama3_1b at full width and depth, flash, batch 2 x 8192, 3
    steps under each remat policy from the same parameters and batches:
    losses within 1e-4 of full's, step time, peak memory and exact flash
    launches; then fp32 at 2 layers (seq 1024): save_proj's loss and every
    gradient within 1e-6 of full's."""
    import dataclasses

    import torch

    from dstack_tpu_torch.workloads import model, train
    from dstack_tpu_torch.workloads.config import get_config
    from dstack_tpu_torch.workloads.kernels import flash

    steps = 3
    launches = dict.fromkeys(flash.launches, 0)
    readings = {}
    for policy in SAVE_PROJ_POLICIES:
        cfg = get_config("llama3_1b", attn_impl="flash", remat=True, remat_policy=policy)
        losses = []
        fresh_peak()
        flash.reset_launches()
        stats = train.train(cfg, steps=steps, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                            device=torch.device("cuda"), on_step=lambda s, x: losses.append(x))
        torch.cuda.synchronize()
        got = default_launches(flash)
        calls = cfg.n_layers * steps
        want = {"flash_fwd": 2 * calls, "flash_bwd_dq": calls, "flash_bwd_dkv": calls}
        if got != want or len(losses) != steps or not all(np.isfinite(losses)):
            raise AssertionError(f"remat {policy}: flash launches {got} != {want}, or losses"
                                 f" {losses}")
        for name, n in got.items():
            launches[name] += n
        readings[policy] = dict(losses=losses, p50_ms=stats["p50_s"] * 1e3,
                                peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        log(f"remat {policy} (llama3_1b, flash, batch {TRAIN_BATCH} x {TRAIN_SEQ}): losses"
            f" {[round(x, 6) for x in losses]}, step p50 {stats['p50_s'] * 1e3:.1f} ms, peak"
            f" memory {readings[policy]['peak_gb']:.2f} GB, flash launches {got} [{card}]")
    for policy in ("dots", "save_proj"):
        gap = max(abs(a - b) for a, b in zip(readings[policy]["losses"],
                                             readings["full"]["losses"]))
        if not gap <= 1e-4:
            raise AssertionError(f"remat {policy}: losses {gap:.3e} from full's")
        log(f"remat {policy}: losses within {gap:.3e} of full's (limit 1e-4)")
    torch.cuda.empty_cache()

    cfg = get_config("llama3_1b", dtype="float32", n_layers=2, attn_impl="flash", remat=True)
    gen = torch.Generator(device="cuda").manual_seed(17)
    init = model.init_params(cfg, gen, torch.device("cuda"))
    tokens = torch.randint(0, cfg.vocab_size, (2, 1024), generator=gen, device="cuda")
    targets = torch.roll(tokens, -1, 1)
    out = {}
    for policy in ("full", "save_proj"):
        params = {k: v.clone().requires_grad_(True) for k, v in init.items()}
        loss = model.loss_fn(params, tokens, targets,
                             dataclasses.replace(cfg, remat_policy=policy))
        loss.backward()
        out[policy] = (loss.item(), {k: p.grad for k, p in params.items()})
    worst = max(float((out["save_proj"][1][k] - g).abs().max() / g.abs().max().clamp(min=1e-30))
                for k, g in out["full"][1].items())
    gap = abs(out["save_proj"][0] - out["full"][0])
    if not (gap <= 1e-6 and worst <= 1e-6):
        raise AssertionError(f"fp32 save_proj against full: loss {gap:.3e}, gradients {worst:.3e}")
    log(f"remat save_proj fp32 identity (llama3_1b width, 2 layers, seq 1024): loss within"
        f" {gap:.3e}, every gradient within {worst:.3e} of its leaf's largest (limit 1e-6)")
    del out, init
    torch.cuda.empty_cache()
    MEASURED["save_proj"] = readings
    return launches


# The MoE mesh paths of 17 (d), as two gloo processes sharing the card:
# moe_test (fp32, seq 256, batch 4) at sp 2 (the preset's routing group of
# 1024 is the whole 256-token sequence, which straddles the two chunks) and
# at fsdp 2 with the all-gather ring.
LAST_MOE_SHAPES = {"sp2": dict(dp=1, fsdp=1, ep=1, tp=1, sp=2),
                   "fsdp2-ring": dict(dp=1, fsdp=2, ep=1, tp=1, sp=1, cfg=dict(fsdp_overlap=True))}


def phase_last_meshes(card: str, workdir: str) -> dict:
    """17 (d): ``--draft-head`` under torchrun at world 1 over NCCL against
    the meshless run (llama3_1b at DEPTH_CUTS' depth, splash W 4096, seq
    2048, 3 steps): losses and the saved .draft bit for bit; MoE under sp 2
    and with the ring at fsdp 2 as two gloo processes on the card against
    meshless (correctness only); four cards over NCCL when the call finds
    them."""
    import os

    import torch

    from dstack_tpu_torch.workloads import checkpoint
    from dstack_tpu_torch.workloads.kernels import splash

    argv = ["--config", "llama3_1b", "--draft-head", "--attn-impl", "splash", "--attn-window",
            "4096", "--steps", "3", "--seq", "2048"]
    code = "import sys, chip_smoke; chip_smoke.handoff_child(*sys.argv[1:])"
    dirs = {k: os.path.join(workdir, f"draft-{k}") for k in ("meshless", "world1", "cards")}
    launches = dict.fromkeys(splash.launches, 0)
    with cut_depth(DEPTH_CUTS):
        ref, _, _ = run_child("draft-meshless", "distill",
                              argv + ["--checkpoint-dir", dirs["meshless"]], workdir)
        (got, _), = [(r, out) for r, out, _ in run_ranks(
            "draft-world1", code, ["distill", json.dumps(argv + ["--checkpoint-dir",
                                                                  dirs["world1"]])],
            1, workdir, 600)]
        runs = {"world1": got}
        if torch.cuda.device_count() >= 4:
            runs["cards"] = run_ranks("draft-cards", code, ["distill", json.dumps(
                argv + ["--checkpoint-dir", dirs["cards"], "--tp", "2"])], 4, workdir,
                600)[0][0]
        for report in (ref, got):
            for name in launches:
                launches[name] += report["splash"][name]
    step = 3

    def draft(path):
        manager = checkpoint.CheckpointManager(path)
        template = {leaf["key"][len(".draft['"):-2]: checkpoint.LeafSpec(
            tuple(leaf["shape"]), torch.float32) for leaf in manager.read_manifest(step)["leaves"]
            if leaf["key"].startswith(".draft")}
        return manager.restore_subtree(template, step=step, prefix=".draft")[0]

    want = draft(dirs["meshless"])
    if got["losses"] != ref["losses"] or any(
            not torch.equal(v, want[k]) for k, v in draft(dirs["world1"]).items()):
        raise AssertionError(f"--draft-head at world 1: losses {got['losses']} against meshless"
                             f" {ref['losses']}, or the .draft subtree differs")
    log(f"draft head under torchrun at world 1 (NCCL): losses {got['losses']} equal to"
        f" meshless to the last bit, the saved .draft subtree bit for bit [{card}]")
    if "cards" in runs:
        gap = max(abs(runs["cards"]["losses"][s] - ref["losses"][s]) for s in ref["losses"])
        log(f"draft head on four cards (fsdp 2 x tp 2, NCCL): losses {runs['cards']['losses']},"
            f" {gap:.3e} from meshless [{card}]")
    else:
        log(f"draft head on four cards: not run ({torch.cuda.device_count()} card visible)")

    last_moe_meshes(card, workdir)
    return launches


def last_moe_meshes(card: str, workdir: str) -> None:
    """17 (d)'s MoE part: LAST_MOE_SHAPES as two gloo processes sharing the
    card against meshless moe_steps in this process (correctness only)."""
    import torch

    plan = dict(backend="gloo", run=MOE_MESH_RUN, shapes=LAST_MOE_SHAPES)
    code = "import sys, chip_smoke; chip_smoke.moe_mesh_child(*sys.argv[1:])"
    ranks = run_ranks("moe-last", code, [json.dumps(plan)], 2, workdir, 600)
    run = MOE_MESH_RUN
    device = torch.device("cuda", 0)
    for name, shape in LAST_MOE_SHAPES.items():
        cfg = moe_config(run["config"], run["layers"], **run["overrides"], **shape.get("cfg", {}))
        batches = moe_batches(cfg.vocab_size, run["batch"], run["seq"], run["steps"], run["seed"])
        ref = moe_steps(cfg, run["seed"], batches, device)
        for rank, (report, _, _) in enumerate(ranks):
            got = report[name]
            for what in ("losses", "norms"):
                gap = max(abs(a - b) / abs(b) for a, b in zip(got[what], ref[what]))
                if not gap <= MOE_TOL:
                    raise AssertionError(f"moe {name} rank {rank}: {what} {got[what]} against"
                                         f" meshless {ref[what]}")
        log(f"moe_test {name} as two gloo processes on the card (fp32, seq {run['seq']}):"
            f" losses {ranks[0][0][name]['losses']} against meshless {ref['losses']} (limit"
            f" {MOE_TOL:g} relative), step {np.median(ranks[0][0][name]['step_s']) * 1e3:.1f} ms"
            f" (correctness only) [{card}]")



def phase_tiles(card: str) -> dict:
    """17 (a): the tile menu. A pair off the menu raises, and so does a tile
    edge the library is not built at; every pair's flash and splash kernels
    (W 4096, with and without four documents) against their plain versions
    at llama3_1b heads, T 8192 bf16, and at D 64; dq and dk/dv at every pair
    against fp64 sums per head; the planted tile and band faults at each
    pair's own edges; each pair's times. Returns {wrapper: {"pairs":
    {"bqxbk": ...}}}."""
    import torch

    from dstack_tpu_torch.workloads.kernels import flash, splash

    b, h, kh, d, t = SPLASH_GEOMETRY
    x = flash_inputs(b, h, kh, d, t, torch.bfloat16, seed=170)
    q3, k3, v3, do3 = x
    calls = (lambda: flash.flash_fwd(q3, k3, v3, True, (48, 48)),
             lambda: splash.splash_fwd(q3, k3, v3, None, None, True, 4096, (48, 48)))
    for call in calls:
        try:
            call()
        except ValueError as exc:
            log(f"tiles: a pair off the menu raises: {exc}")
        else:
            raise AssertionError("a launch at (48, 48), off the menu, did not raise")
    # A menu entry whose forward edge (48 keys) no kernel is built at: the
    # library returns an error and the wrapper raises.
    flash.TILE_MENU[(48, 48)] = flash.Tiles(fwd=(64, 48), dq=(64, 32), dkv=(32, 64))
    try:
        for call in calls:
            try:
                call()
            except RuntimeError as exc:
                log(f"tiles: a forward tile of 48 keys raises: {exc}")
            else:
                raise AssertionError("a launch at a 48-key tile, which no kernel is built at,"
                                     " did not raise")
    finally:
        del flash.TILE_MENU[(48, 48)]
    try:
        flash.flash_attention(q3[None, :1].transpose(1, 2), k3[None, :1].transpose(1, 2),
                              v3[None, :1].transpose(1, 2), block_q=48, block_k=48)
    except ValueError as exc:
        log(f"tiles: flash_attention(block_q=48, block_k=48) raises: {exc}")
    else:
        raise AssertionError("flash_attention at blocks off the menu did not raise")
    for blocks, tiles in flash.TILE_MENU.items():
        log(f"tiles {blocks[0]}x{blocks[1]}: fwd {tiles.fwd}, dq {tiles.dq}, dk/dv {tiles.dkv}"
            f" (rows, keys)")
    report: dict = {}
    docs = doc_plane(SPLASH_DOCS, b)
    label = "llama3_1b heads, T=8192"
    tiles_compare("flash", label, x, None, 0, report)
    tiles_compare("splash", label, x, None, TILES_WINDOW, report)
    tiles_compare("splash", label, x, docs, TILES_WINDOW, report)
    pairs = list(flash.TILE_MENU)
    for do_label, d_o in (("fp32 do", do3), ("do of bf16 values", do3.bfloat16().float())):
        flash_bwd_against_fp64(f"{label}, every menu pair, {do_label}", q3, k3, v3, d_o,
                               pairs=pairs)
        flash_bwd_against_fp64(f"{label}, window={TILES_WINDOW}, every menu pair, {do_label}",
                               q3, k3, v3, d_o, window=TILES_WINDOW, pairs=pairs)
    for blocks in pairs:
        tiles = menu_tiles(blocks)
        flash_planted_faults(f"{label} at {blocks[0]}x{blocks[1]}", *x,
                             tiles=(tiles["fwd"][1], tiles["bwd_dq"][1], tiles["bwd_dkv"][0]))
        splash_planted_faults(f"{label} at {blocks[0]}x{blocks[1]}", *x, TILES_WINDOW,
                              tiles={f"splash_{k}": v for k, v in tiles.items()})
    tiles_timing("flash", x, 0, report)
    tiles_timing("splash", x, TILES_WINDOW, report)
    del x, docs
    torch.cuda.empty_cache()
    b, h, kh, d, t = TILES_D64
    x = flash_inputs(b, h, kh, d, t, torch.bfloat16, seed=171)
    label = f"B {b}, H {h}, Kh {kh}, D {d}, T={t}"
    tiles_compare("flash", label, x, None, 0, report)
    tiles_compare("splash", label, x, None, 1024, report)
    tiles_compare("splash", label, x, doc_plane((700, 900, 448), b), 1024, report)
    del x
    torch.cuda.empty_cache()
    return {name: {"pairs": entry} for name, entry in report.items()}



def add_pair_launches(report: dict, launches: dict, tuned: dict) -> None:
    """Each menu pair's launches on the main paths, into the kernels line,
    and 17 (b)'s into ``launches``. Every count already in ``launches`` was
    read from the wrappers' pair counts at DEFAULT_BLOCKS (default_launches,
    or a child's stray_pairs checked empty); ``tuned`` holds 17 (b)'s
    counts by pair."""
    from collections import Counter

    from dstack_tpu_torch.workloads.kernels.flash import DEFAULT_BLOCKS

    for name, entry in report.items():
        if "pairs" not in entry:
            continue
        by_pair = Counter({"%dx%d" % DEFAULT_BLOCKS: launches[name]})
        by_pair.update(tuned.get(name, {}))
        if set(by_pair) - set(entry["pairs"]):
            raise AssertionError(f"{name}: launches at pairs off the menu: {dict(by_pair)}")
        for key, pair in entry["pairs"].items():
            pair["launches"] = by_pair[key]
        launches[name] = sum(by_pair.values())
        log(f"{name}: launches on the main paths by pair {dict(by_pair)}")


def main() -> int:
    import tempfile

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2
    from dstack_tpu_torch.workloads.kernels import autotune

    # Every phase and child (they inherit the environment) runs with an empty
    # autotune cache of this run's own, so the kernels run the default pair
    # whatever a cache under HOME holds; 17 (b) tunes in a directory of its own.
    with tempfile.TemporaryDirectory(prefix="chip-smoke-autotune-") as tune_dir:
        os.environ[autotune.ENV_DIR] = tune_dir
        return run_phases(tune_dir)


def run_phases(tune_dir: str) -> int:
    import torch

    from dstack_tpu_torch.workloads.kernels import build, platform

    t_start = time.monotonic()
    card = card_line()
    log(card)
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind}, {torch.cuda.device_count()} visible, torch {torch.__version__},"
        f" CUDA {torch.version.cuda}")
    platform.require_sm90(torch.device("cuda"))
    platform.set_reference_matmul_precision()
    t0 = time.monotonic()
    libs = build.build_all()
    log(f"build: {', '.join(p.name for p in libs)} in {time.monotonic() - t0:.1f} s")
    for name, text in sorted(build.build_logs.items()):
        for line in ptxas_summary(text):
            log(f"ptxas {name}: {line}")

    def done(phase: str) -> None:
        log(f"phases to {phase} done at {time.monotonic() - t_start:.1f} s")

    report = phase_kernels(card)
    report.update(phase_flash())
    done("flash")
    launches = phase_serve(card)
    cfg, params = phase_identity()
    phase_http(cfg, params)
    del params
    done("http")
    launches.update(phase_train(card))
    phase_train_identity()
    done("train identity")
    report.update(phase_splash())
    launches.update(phase_train_splash(card))
    phase_splash_identity()
    done("splash identity")
    try:
        with cut_depth(DEPTH_CUTS):
            for name, n in phase_handoff(card).items():
                launches[name] += n
            done("handoff")
            for name, n in phase_mesh(card).items():
                launches[name] += n
            done("mesh")
            serve_mesh = phase_serve_mesh(card)
            done("serve mesh")
        for name, n in phase_moe(card).items():
            launches[name] += n
        done("moe")
    finally:
        import shutil

        shutil.rmtree(MEASURED.get("handoff_dir", ""), ignore_errors=True)
    for name, n in serve_mesh["launches"].items():
        launches[name] += n
    for name, entry in serve_mesh["report"].items():
        report[name].update(entry)
    for name, n in phase_mesh_axes(card).items():
        launches[name] += n
    done("mesh axes")
    for name, entry in phase_tiles(card).items():
        report[name].update(entry)
    done("tiles")
    tuned = phase_autotune(card)
    for name, n in phase_save_proj(card).items():
        launches[name] += n
    import tempfile

    with tempfile.TemporaryDirectory(prefix="last-paths-") as workdir:
        for name, n in phase_last_meshes(card, workdir).items():
            launches[name] += n
    done("last paths")
    if os.listdir(tune_dir):
        raise AssertionError(f"the main paths wrote an autotune cache: {os.listdir(tune_dir)}")
    add_pair_launches(report, launches, tuned)

    replaces = {
        "paged_decode_attention": "dstack_tpu/workloads/kernels/paged.py:47",
        "paged_chunk_attention": "dstack_tpu/workloads/kernels/paged.py:157",
        "flash_fwd": "dstack_tpu/workloads/kernels/flash.py:57",
        "flash_bwd_dq": "dstack_tpu/workloads/kernels/flash.py:165",
        "flash_bwd_dkv": "dstack_tpu/workloads/kernels/flash.py:218",
        "splash_fwd": "dstack_tpu/workloads/kernels/splash.py:134",
        "splash_bwd_dq": "dstack_tpu/workloads/kernels/splash.py:230",
        "splash_bwd_dkv": "dstack_tpu/workloads/kernels/splash.py:279",
    }
    sources = {"paged": KERNEL_SOURCE, "flash": FLASH_SOURCE, "splash": SPLASH_SOURCE}
    kernels = []
    for name, entry in report.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": sources[name.split("_")[0]],
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": entry["max_abs_err"], "ms": entry["ms"],
            "plain_ms": entry["plain_ms"], "bound_ms": entry["bound_ms"],
            "bound_by": entry["bound_by"], "library_ms": entry["library_ms"],
            **{key: value for key, value in entry.items()
               if key in ("device_ms", "library_device_ms", "pairs")
               or key.startswith(("verify_", "rank_"))
               or key.endswith("_max_abs_err")},
        })
    log(f"total {time.monotonic() - t_start:.1f} s [{card}]")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
