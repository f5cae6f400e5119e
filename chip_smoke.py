#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py

1. Builds every CUDA source of the port (one nvcc per source, started
   together) into build/kernels/.
2. Kernel phase: each hand-written kernel against its plain PyTorch
   version on the card — the forward at the serving prefill and the
   training shape, the backward kernels at the training shape (b 8,
   2048 tokens, 8 heads over 4 kv heads, window 1024), fp32 and bf16,
   every kernel at the d-12 LM's shape in both dtypes, and small edge
   cases (also at head dims 13 and 36) — with its time, the plain
   version's time, the least time the card could take (bound) and one
   PyTorch library call computing the same function, timed as a
   yardstick only. bf16 at a head_dim that is a multiple of 8 takes the
   wgmma tensor-core kernels (flash_fwd_sm90, flash_bwd_dq_sm90,
   flash_bwd_dkv_sm90); every other float32 or bf16 head_dim the
   split-TF32 tensor-core kernels (flash_fwd_tf32x3,
   flash_bwd_dq_tf32x3, flash_bwd_dkv_tf32x3). Each bf16 case of the
   wgmma route is held twice more: to the derived bound of bf16 P and dS
   against the float32 plain version, and tightly against the plain
   version with P and dS split into bf16 hi + lo as the kernels split
   them; each case of the split-TF32 route, float32 or bf16, against the
   plain version that splits every product 3xTF32 as the kernels do, at
   the float32 tolerance (a bf16 o within one bf16 ulp).
3. Serving path: a REST server on the card serving the tutorial's LM
   (vocab 32000, d_model 512, 8 layers, 8 heads over 4 kv heads, window
   1024, random weights from seed 0), four concurrent predicts of
   1100-1500-token prompts, 32 greedy tokens each, sent twice (cold,
   then warm), float32: every prefill layer runs flash_fwd_tf32x3 and
   nothing else. Each stream must equal the port's solo ``generate``;
   the prefill logits through the kernel must agree with the dense path.
   Paged path (the ``paged`` line): the same prompts through ``kv:
   "paged"`` (16-token pages, the pool at the slot cache's bytes: 513
   pages) must give the slot session's and solo ``generate``'s tokens
   with 8 flash_fwd_tf32x3 launches a prefill; the 1500-token prompt
   again is a prefix hit with no launch, a prompt sharing 1024 tokens
   reuses 64 pages; 16 streams of 64-448 prompt tokens decode at once on
   the same 513 pages; int8 KV with int8 weights must stamp a drift of at
   most 0.05, fp8 weights are measured (and degrade at create where their
   drift is over it), and a drift max of 1e-9 must degrade a session to
   exact, which then answers the exact tokens; a profiled paged decode
   step beside the serving phase's slot one.
4. Training path: ``LanguageModel.fit`` of the same LM from
   ``init_params(seed 0)`` on 64 windows of 2048 tokens of a
   cyclic-successor stream, batch 16, 2 epochs, grad_accum 2, bf16
   compute: the loss must be finite, fall, and stay within 1% of the
   first (CUDA-core) kernels' epoch losses, and the forward, dq and dK/dV must
   run once per layer and micro-batch, all three on the tensor-core
   route. A profiler window of 2 steps gives the kernels' time per step
   and the card's idle share. A float32 window of the same fit (2
   optimizer steps of 16 windows, grad_accum 2) runs the split-TF32
   kernels and reports its own step time and profile (the
   ``trainFloat32`` line). In float32 one micro-step's gradients
   through the kernels must match the dense path's, for the tutorial LM
   (split-TF32 kernels) and for a small LM with head_dim 12 (d_model
   96, 8 heads: the split-TF32 kernels' width-16 variants); the same
   small LM takes one bf16 micro-step through the same kernels.
   The trained artifact is then served over REST and must answer with
   its reloaded copy's ``generate``.
5. Pipeline path: the tutorial's LM workflow over HTTP only, on a
   RestServer whose context is on the card, bf16 compute: the train
   phase's 64 windows as a CSV through ``POST /dataset/csv`` (the first
   page must hold the metadata document and the first window, ``$corpus``
   the windows exactly), ``POST /model/tensorflow`` of the tutorial LM
   through the JAX package's module path, ``POST /train/tensorflow``
   ``fit`` with the tutorial's ``"checkpoint": true`` (its epoch losses
   must equal the train phase's, with 8 layers x 16 micro-batches of each
   wgmma kernel and nothing else, and a verified step dir after each
   epoch), ``evaluate`` (within 1e-6 relative of the train phase's
   model), ``generate`` of 32 tokens after 1100 (equal to the reloaded
   artifact's solo ``generate``; its float32 prefill on
   flash_fwd_tf32x3) and ``POST /serve`` of the trained artifact (the
   same tokens). Resume: a 1-epoch checkpointed fit PATCHed to 2 epochs
   restores its step and trains epoch 2 with the uninterrupted fit's loss
   bit for bit (params and evaluate equal too); again after one byte of
   the newest step is flipped (the step goes to the quarantine and the
   run restores the one before); DELETE removes the checkpoint dir. LoRA:
   a second corpus, ``enable_lora`` rank 16 on the trained LM, a 2-epoch
   fit of the adapters alone (8 layers x 8 steps of each wgmma kernel,
   the base bit-identical, every adapter moved, the loss falling),
   ``merge_lora`` (float32 evaluate within 1e-5 relative of the adapted
   model's) and the tutorial's sampled ``generate`` (equal to the merged
   artifact's solo ``generate``). A ``timeout`` field must get 406 and
   leave no collection; a fit on a missing ``$`` reference must end with
   ``finished`` false and an exception document. Clients poll every 0.25
   s, as the JAX package's client does.
6. Classifier path: the tutorial's TextClassifier (vocab 20000, d_model
   256, 4 layers, 8 heads over 4, head_dim 32) with ``attention="flash"``
   in bf16: a 3-epoch fit of 1024 rows of 512 tokens (lengths 64-512,
   padded; the label is whether a marker id appears) at batch 128, 4
   layers x 24 steps of each wgmma kernel (non-causal) and nothing else;
   the loss falls, ``predict`` rows sum to 1, the artifact round-trips;
   one float32 gradient micro-step through the split-TF32 kernels within
   1e-4 per-tensor relative L2 of the dense path; ``POST /model`` of the
   tutorial's body answers 201 and finishes. The kernel phase measures
   the three wgmma kernels at this shape (b 128, 512 tokens, bf16).
7. LM options path (the ``lmOptions`` line, after the pipeline): the
   tutorial LM with a mixture of experts (Mixtral-8x7B's router: 8
   experts, 2 a token; the JAX package's GELU experts, capacity factor
   1.25) from ``init_params(seed 0)``, created and fitted over REST in
   bf16 on the train phase's windows (8 layers x 16 micro-batches of each
   wgmma kernel and nothing else, the loss falling, a positive
   load-balance term, one step repeated from one state bit-identical),
   its float32 gradient micro-step through the split-TF32 kernels within
   1e-4 of the dense path; remat ``none``/``dots``/``full`` on the dense
   LM under dropout 0.1 (equal first losses, falling peak memory, the
   forward relaunched by the recompute, float32 gradients within 1e-4);
   fused projections against their split trees (float32 logits within
   1e-4, one fit step); beam search over REST (1 beam equals greedy, 4
   beams score at least greedy's log-prob); the trained MoE LM on a slot
   and a paged session (8 forward launches a prefill; agreement with
   solo recorded: capacity makes lanes compete, as in the JAX package);
   and a retired paged lane whose column lies past the step's page
   slice, which must append to the trash page without a device assert.
8. Serving plane (the ``servingPlane`` line, last): the train phase's LM
   served in float32 with speculative decoding, disaggregated prefill and
   decode, and the classifier phase's TextClassifier bucketed. A draft
   LM (vocab 32000, d_model 256, 2 layers, 4 heads over 2, window 1024)
   is fitted in bf16 on the train phase's windows (the sm90 kernels,
   2 layers x steps of each, nothing else) until its loss is below the
   target's epoch 2 or for 8 steps. Prompts of 1100-1500 successor
   tokens and one of 1200 random ids, 32 greedy tokens each, 4 slots,
   16-token pages: (a) the target as its own draft, specK 4, every
   stream equal to solo ``generate`` (acceptance against its
   end-of-stream bound recorded); (b) ``disagg: true`` with the small
   draft, every stream equal to solo, mode colocated, a handoff a
   request, an empty queue, the roles prefill/decode/draft, exactly 8
   flash_fwd_tf32x3 launches a target prefill and 2 a draft prefill and
   none in a verify or propose step, the pool back to the prefix cache's
   holds after delete (TTFT, decode tokens/s against a plain paged
   session and the draft's ms a round recorded); (c) the
   ``kv_page_handoff`` fault: one 429 without a leaked page, and latched,
   three 429s, a collapse to fused serving whose tokens equal solo; (d)
   two streams decoding while two 1500-token prompts arrive, fused and
   disaggregated: the gaps between their tokens recorded, every token
   equal to solo; (e) int8 KV with the self-draft: every request 200,
   agreement recorded; (f) ``type: "predict"`` of the classifier: bursts
   of 1, 3 and 5 rows in buckets 1, 4 and 8 and three concurrent
   clients, each row within 1e-5 of a direct ``predict`` of its padded
   bucket, 4 layers x predict calls of flash_fwd_sm90 and nothing else.
9. The keras path (the ``neural`` line, after the serving plane):
   ``NeuralModel`` at the published widths with data from seeds, bf16.
   (a) The tutorial's MNIST CNN (``docs/TUTORIAL.md`` workflow 2: conv
   32 3x3, max pool, dense 128, dense 10) fitted directly on 60000 rows
   of 784 pixels (class templates plus noise), batch 256, 2 epochs: the
   loss falls, accuracy well above chance; step ms, samples/s and a
   profiled window's idle share; one float32 step on the card within
   1e-4 (loss and each gradient's relative L2) of the same step on the
   CPU. (b) Workflow 2 over HTTP: pixels and labels of 1024 rows as two
   CSVs, ``/model``, ``/train`` with ``"checkpoint": true`` (its epoch
   losses within 1e-5 relative of a direct fit's on the same rows, bit
   equality recorded), ``/evaluate``, ``/predict`` (rows sum to 1), and
   a 1-epoch fit PATCHed to 2 that restores its step and trains epoch 2
   as the uninterrupted fit does. (c) Workflow 3's LSTM (embedding
   20000/128, lstm 128, dense 2) on 25000 rows of 200 ids, batch 128, 1
   epoch: the loss falls; the RNN route and the kernels it ran; float32
   steps of ``gru`` and ``bidirectional_lstm`` bodies within 1e-4 of the
   CPU. (d) ResNet-50 (1000 classes, 224x224x3, a softmax output
   activation as keras's), batch 64, 8 steps: a
   finite loss, every batch statistic moved, ``predict`` rows summing to
   1; step ms, images/s, peak memory. (e) The tune route: a
   ``GridSearch`` over (b)'s CNN (``learning_rate`` 1e-3/3e-4 x
   ``batch_size`` 128/256, 1 epoch) through ``/model`` and ``/tune``: 4
   trials and a refit, ``sweepFusion`` in the metadata, each trial's card
   memory freed before the next starts (what is live at a trial's start
   varies by at most 1 MiB) and its peak flat across trials of one batch
   size (within 10%); then
   a ``RandomSearch`` of 2 points over the tutorial TextClassifier
   (flash, bf16) on 1024 rows of 512 tokens: each sm90 kernel launched
   exactly 4 layers x the optimizer steps of the trials and the refit,
   the forward once more a layer for each evaluate batch, nothing else.

The kernel launch counts are zeroed just before each path and read
just after it. ``python3 chip_smoke.py --only neural`` builds the
kernels and runs that phase alone (to iterate on it), printing its line
and no result line.

Earlier lines print the card (nvidia-smi name and power limit), the
build time, ptxas's registers and spill bytes of every kernel variant
(a tensor-core variant, sm90 or tf32x3, that spills fails the run),
the ``kernels`` JSON
line and the phases' lines; the last
line is ``{"ok": true, "device": {...}}``. Any failed check raises and
the exit code is not 0. Without a card, or without the package beside
it, the script exits 2 and prints no result.
"""

from __future__ import annotations

import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import urllib.error
import urllib.request

PREFIX = "/api/learningOrchestra/v1"
# H100 SXM peaks (NVIDIA data sheet, dense): float32 outside the tensor
# cores, bf16 and TF32 on the tensor cores, HBM3 bandwidth
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "tf32": 495e12}
PEAK_BYTES = 3.35e12
LM_CONFIG = dict(vocab_size=32000, d_model=512, n_layers=8, n_heads=8,
                 n_kv_heads=4, d_ff=0, max_len=2048, sliding_window=1024,
                 rope_base=10000.0)
PROMPT_LENS = (1100, 1234, 1367, 1500)
NEW_TOKENS = 32
# a small LM whose head_dim (96 / 8 = 12) is not a multiple of 8: both
# passes run the split-TF32 kernels' width-16 variants, in either dtype
D12_CONFIG = dict(LM_CONFIG, d_model=96, n_layers=2)
# the training path: 64 windows of 2048 tokens, batch 16, 2 epochs,
# grad_accum 2 -> 8 optimizer steps of 2 micro-batches
TRAIN_WINDOWS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_EPOCHS, TRAIN_ACCUM = \
    64, 2048, 16, 2, 2
# each kernel (one per CUDA source) and the counter its wrapper adds one
# to at each launch
COUNTERS = {"flash_fwd_sm90": "FLASH_FWD_SM90_LAUNCHES",
            "flash_bwd_dq_sm90": "FLASH_BWD_DQ_SM90_LAUNCHES",
            "flash_bwd_dkv_sm90": "FLASH_BWD_DKV_SM90_LAUNCHES",
            "flash_fwd_tf32x3": "FLASH_FWD_TF32X3_LAUNCHES",
            "flash_bwd_dq_tf32x3": "FLASH_BWD_DQ_TF32X3_LAUNCHES",
            "flash_bwd_dkv_tf32x3": "FLASH_BWD_DKV_TF32X3_LAUNCHES"}
# the tutorial's LoRA fine-tune: rank 16 on a second corpus of 64 windows,
# batch 16, 2 epochs (8 optimizer steps, no accumulation)
LORA_RANK, LORA_BATCH, LORA_EPOCHS = 16, 16, 2
# the tutorial's sampled generate on the merged model
TUTORIAL_GENERATE = {"prompt": [[101, 2023, 2003]], "max_new_tokens": 64,
                     "temperature": 0.8, "top_p": 0.9}
# the tutorial's TextClassifier (head_dim 32: the sm90 kernels, non-causal)
CLF_CONFIG = dict(vocab_size=20000, n_classes=2, d_model=256, n_layers=4,
                  n_heads=8, n_kv_heads=4, max_len=512)
# 1024 rows of 512 tokens, batch 128, 3 epochs -> 24 optimizer steps
CLF_ROWS, CLF_SEQ, CLF_BATCH, CLF_EPOCHS = 1024, 512, 128, 3
# epoch losses of the train phase's fit through the first, CUDA-core
# kernels (bf16; PERF.md), which the tensor-core route must stay within
# 1% of
CUDA_CORE_LOSSES = (8.82798957824707, 3.2666094303131104)


def _reset_launches(attn) -> None:
    for counter in COUNTERS.values():
        setattr(attn, counter, 0)


def _launches(attn) -> dict:
    """Launches of each kernel (one per CUDA source) since the reset."""
    return {name: getattr(attn, counter)
            for name, counter in COUNTERS.items()}


def _kernel_name(mangled: str) -> str:
    """``flash_bwd_dq_tf32x3_kernel<bf16,16,0>`` from ptxas's mangled
    name (types, ints, and bools as 0 or 1)."""
    m = re.search(r"(?<=\d)(flash_\w*?_kernel)I(.+?)EEv", mangled)
    if not m:
        return mangled
    args = [n or b or ("bf16" if bf else "float") for n, b, bf, _ in
            re.findall(r"Li(\d+)E|Lb(\d)|(13__nv_bfloat16)|(f)",
                       m.group(2))]
    return f"{m.group(1)}<{','.join(args)}>"


def _ptxas_report(log: str) -> list:
    """Registers and spill bytes of each kernel variant in ``nvcc
    -Xptxas=-v`` output."""
    out = []
    for line in log.splitlines():
        m = re.search(r"entry function '(\S+)'", line)
        if m:
            out.append({"kernel": _kernel_name(m.group(1))})
        elif out and (m := re.search(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            out[-1].update(spillStores=int(m.group(1)),
                           spillLoads=int(m.group(2)))
        elif out and (m := re.search(r"Used (\d+) registers", line)):
            out[-1]["registers"] = int(m.group(1))
    return out


def _time_ms(torch, fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _visible_mask(torch, sq, sk, causal, window, offset, device):
    row = torch.arange(sq, device=device)[:, None]
    col = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= row >= col + offset
    if window > 0:
        mask &= col + offset > row - window
    return mask


def _split_fwd(torch, attn, q, k, v, causal, scale, window, offset):
    """The plain forward with the weights exp(s - m) split into bf16 hi
    + lo before the product with v, as flash_fwd_sm90 multiplies them,
    and each element's bound term sum_j p_j |v_j| / l. float32, (b, sq,
    h, d) each."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, sq, kvh, h // kvh, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    valid = attn._visible(sq, sk, causal, window, offset, q.device)
    s = torch.where(valid, s, attn.NEG_INF)
    e = torch.where(valid, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    del s
    l = e.sum(dim=-1, keepdim=True)
    inv = torch.where(l > 0, 1.0 / l, 0.0).permute(0, 3, 1, 2, 4)
    o = torch.einsum("bhgqk,bkhd->bqhgd", attn._bf16_split(e), v.float())
    w = torch.einsum("bhgqk,bkhd->bqhgd", e, v.float().abs())
    return (o * inv).reshape(b, sq, h, d), (w * inv).reshape(b, sq, h, d)


def _split_bwd(torch, attn, q, k, v, o, lse, do, dlse, causal, scale,
               window, offset):
    """flash_bwd_reference's dQ, dK and dV with P and dS split into bf16
    hi + lo before the products, as flash_bwd_dq_sm90 and
    flash_bwd_dkv_sm90 multiply them, and each element's bound terms
    sum |ds| |k|, sum |ds| |q| and sum p |dO|. float32."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, sq, kvh, h // kvh, d)
    dog = do.float().reshape(b, sq, kvh, h // kvh, d)
    valid = attn._visible(sq, sk, causal, window, offset, q.device)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    p = torch.exp(torch.where(valid, s - attn._by_group(lse.float(), kvh),
                              attn.NEG_INF))
    del s
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v.float())
    ds = p * (dp - attn._by_group(attn._bwd_delta(o, do, dlse), kvh)) \
        * scale
    del dp
    ds_split = attn._bf16_split(ds)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds_split, k.float()) \
        .reshape(b, sq, h, d)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds_split, qg)
    del ds_split
    dv = torch.einsum("bhgqk,bqhgd->bkhd", attn._bf16_split(p), dog)
    bq = torch.einsum("bhgqk,bkhd->bqhgd", ds.abs(), k.float().abs()) \
        .reshape(b, sq, h, d)
    bk = torch.einsum("bhgqk,bqhgd->bkhd", ds.abs(), qg.abs())
    bv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog.abs())
    return dq, dk, dv, bq, bk, bv


def kernel_phase(torch, log):
    """The forward kernels against flash_attention_reference on the card,
    by route (:func:`_route`): flash_fwd_sm90 (bf16 at a head_dim that is
    a multiple of 8, wgmma tensor cores) and flash_fwd_tf32x3 (every
    other float32 or bf16 head_dim, split-TF32 tensor cores). Returns the
    kernels-line entries: flash_fwd_tf32x3 at the slice's shape (its main
    path, serving) with its training-shape and d-12 numbers nested,
    flash_fwd_sm90 at the training path's bf16 shape."""
    import torch.nn.functional as F

    from learningorchestra_tpu_torch.ops import attention as attn

    gen = torch.Generator(device="cuda").manual_seed(0)
    f32, bf16 = torch.float32, torch.bfloat16
    # (name, b, sq, sk, h, kvh, d, causal, window, kv_offset, dtype)
    cases = [
        ("slice", 1, 1536, 1536, 8, 4, 64, True, 1024, 0, f32),
        ("slice", 1, 1536, 1536, 8, 4, 64, True, 1024, 0, bf16),
        # a main-path prompt length: the last q tile is ragged
        ("prefill-1500", 1, 1500, 1500, 8, 4, 64, True, 1024, 0, f32),
        ("prefill-1500", 1, 1500, 1500, 8, 4, 64, True, 1024, 0, bf16),
        ("non-causal", 2, 96, 96, 4, 2, 64, False, 0, 0, f32),
        ("non-causal", 2, 96, 96, 4, 2, 64, False, 0, 0, bf16),
        ("mqa", 2, 130, 130, 8, 1, 64, True, 0, 0, f32),
        ("mqa", 2, 130, 130, 8, 1, 64, True, 0, 0, bf16),
        ("ragged-sk", 2, 77, 201, 4, 2, 32, False, 0, 0, f32),
        ("ragged-sk", 2, 77, 201, 4, 2, 32, False, 0, 0, bf16),
        ("offset-empty-rows", 2, 64, 64, 4, 4, 128, True, 16, 40, f32),
        ("offset-empty-rows", 2, 64, 64, 4, 4, 128, True, 16, 40, bf16),
        ("offset-empty-rows", 1, 64, 64, 4, 4, 64, True, 16, 40, bf16),
        ("offset-empty-rows", 1, 64, 64, 4, 4, 64, True, 16, 40, f32),
        # the training path's shape: bf16 is its dtype, float32 the
        # float32 fit's
        ("train", 8, 2048, 2048, 8, 4, 64, True, 1024, 0, bf16),
        ("train", 8, 2048, 2048, 8, 4, 64, True, 1024, 0, f32),
        # the d-12 LM's micro-step (2 windows of 2048): the split-TF32
        # kernel's width-16 variant in both dtypes
        ("lm-d12", 2, 2048, 2048, 8, 4, 12, True, 1024, 0, f32),
        ("lm-d12", 2, 2048, 2048, 8, 4, 12, True, 1024, 0, bf16),
        # an odd head_dim (a bf16 row of odd length loads element by
        # element; o's last pair is a single column) with ragged sq and
        # sk, and a kv_offset that leaves rows with no visible key; every
        # head its own kv head, so o and lse are compared on every head
        ("ragged-offset-empty-rows-d13", 2, 75, 131, 4, 4, 13, True, 16,
         40, f32),
        ("ragged-offset-empty-rows-d13", 2, 75, 131, 4, 4, 13, True, 16,
         40, bf16),
        # a multiple of 4 but not of 8, between the kernels' widths, GQA
        ("gqa-window-d36", 2, 160, 160, 8, 2, 36, True, 48, 0, f32),
        ("gqa-window-d36", 2, 160, 160, 8, 2, 36, True, 48, 0, bf16),
        # the classifier's fit: a batch of 128 rows of 512 tokens, 8
        # heads over 4 at head_dim 32, bidirectional
        ("classifier", 128, 512, 512, 8, 4, 32, False, 0, 0, bf16),
    ]
    # (atol, rtol). float32: summation order only (the split-TF32 route's
    # products depart from float32 ones by about 2**-22 of sum |x||y|).
    # bf16: o is rounded once from float32 by kernel and plain version
    # alike, so they differ by at most one bf16 ulp of |o| (<= 2**-7 |o|,
    # under rtol) plus the float32 error (under atol); the wgmma kernel
    # adds its bf16 hi + lo split of P, about 2**-16 of the product
    tols = {f32: (2e-5, 2e-5), bf16: (1e-4, 1e-2)}
    # the counter each route's wrapper adds one to
    routed = {"sm90": "FLASH_FWD_SM90_LAUNCHES",
              "tf32x3": "FLASH_FWD_TF32X3_LAUNCHES"}
    entries = {}
    for (name, b, sq, sk, h, kvh, d, causal, window, offset,
         dtype) in cases:
        def rand(*shape):
            return torch.randn(*shape, device="cuda", generator=gen) \
                .to(dtype)

        q, k, v = rand(b, sq, h, d), rand(b, sk, kvh, d), rand(b, sk, kvh, d)
        with_lse = h == kvh
        route = attn._route(q)
        want_route = "sm90" if dtype == bf16 and d % 8 == 0 else "tf32x3"
        sm90 = route == "sm90"
        scale = 1.0 / d ** 0.5

        def kernel():
            if with_lse:
                return attn.flash_attention_with_lse(
                    q, k, v, causal=causal, window=window, kv_offset=offset)
            return attn.flash_attention(q, k, v, causal=causal,
                                        window=window), None

        def plain(split=False):
            return attn.flash_attention_reference(
                q, k, v, causal=causal, window=window, kv_offset=offset,
                tf32x3=split)

        before = {r: getattr(attn, c) for r, c in routed.items()}
        o, lse = kernel()
        torch.cuda.synchronize()
        ran = {r: getattr(attn, c) - before[r] for r, c in routed.items()}
        if route != want_route or ran != {r: int(r == route)
                                          for r in routed}:
            raise AssertionError(f"flash_fwd {name} {dtype}: took the "
                                 f"{route} route, want {want_route} "
                                 f"(launches {ran})")
        ro, rlse = plain()
        diff = (o.float() - ro.float()).abs()
        err = diff.max().item()
        atol, rtol = tols[dtype]
        # worst |o - ro| / (atol + rtol |ro|); <= 1 passes
        excess = (diff / (atol + rtol * ro.float().abs())).max().item()
        if not excess <= 1.0:
            raise AssertionError(f"flash_fwd {name} {dtype}: |o - ro| "
                                 f"exceeds atol {atol} + rtol {rtol} |ro| "
                                 f"by {excess}x (max abs err {err})")
        line = {"case": name, "dtype": str(dtype).split(".")[-1],
                "kernel": f"flash_fwd_{route}",
                "shape": [b, sq, sk, h, kvh, d], "causal": causal,
                "window": window, "kvOffset": offset, "maxAbsErr": err,
                "atol": atol, "rtol": rtol, "tolUsed": excess}
        if sm90:
            # (a) against the float32 plain version at the derived bound
            # of bf16 P, 2**-8 sum p |v| / l, plus o's own rounding (one
            # bf16 ulp, <= 2**-7 |ro|); (b) against the plain version
            # with P split as the kernel splits it: float32 order (2**-14
            # of the bound term) plus o's rounding
            eo, w = _split_fwd(torch, attn, q, k, v, causal, scale, window,
                               offset)
            used_a = (diff / (2.0 ** -8 * w + 2.0 ** -7 * ro.float().abs()
                              + 1e-5)).max().item()
            eo = eo.to(dtype).float()
            used_b = ((o.float() - eo).abs()
                      / (2.0 ** -14 * w + 2.0 ** -7 * eo.abs() + 1e-6)) \
                .max().item()
            del eo, w
            if not (used_a <= 1.0 and used_b <= 1.0):
                raise AssertionError(
                    f"flash_fwd_sm90 {name}: bound used {used_a}x, "
                    f"split emulation tolerance used {used_b}x")
            line.update(derivedBoundUsed=used_a, splitEmulationUsed=used_b)
        else:
            # against the plain version that splits both products 3xTF32
            # as the kernel does, at the same tolerance
            eo, e_lse = plain(split=True)
            used = ((o.float() - eo.float()).abs()
                    / (atol + rtol * eo.float().abs())).max().item()
            seen = e_lse != attn.NEG_INF
            lse_used = ((lse - e_lse)[seen].abs().max().item() / 1e-4
                        if lse is not None else 0.0)
            del eo, e_lse
            if not (used <= 1.0 and lse_used <= 1.0):
                raise AssertionError(
                    f"flash_fwd_tf32x3 {name} {dtype}: split emulation "
                    f"tolerance used {used}x (lse {lse_used}x)")
            line["splitEmulationUsed"] = used
        empty = 0
        if lse is not None:
            # rows with no visible key carry exactly NEG_INF in both
            seen = rlse != attn.NEG_INF
            if not torch.equal(seen, lse != attn.NEG_INF):
                raise AssertionError(f"flash_fwd {name}: empty rows differ")
            lse_err = (lse - rlse)[seen].abs().max().item()
            if not lse_err <= (2e-5 if sm90 else 1e-4):
                raise AssertionError(f"flash_fwd {name}: lse err {lse_err}")
            empty = int((~seen).sum())
            if offset and not (empty and bool((o[~seen] == 0).all())):
                raise AssertionError(f"{name}: no empty rows, or empty "
                                     f"rows with a non-zero o")
            line["lseMaxAbsErr"] = lse_err
        line["emptyRows"] = empty
        if name in ("slice", "train", "lm-d12", "classifier"):
            mask = _visible_mask(torch, sq, sk, causal, window, offset,
                                 q.device)
            pairs = int(mask.sum())
            flops = 4.0 * d * pairs * h * b
            nbytes = (2 * q.numel() + k.numel() + v.numel()) \
                * q.element_size() + 4 * b * sq * h
            dt = line["dtype"]
            # the least time for the function on these inputs, whatever
            # the route: bf16 inputs at the card's bf16 rate, float32 ones
            # as three TF32 products; float32 FMAs beside it, and the
            # split work the route runs (wgmma: P split hi + lo, 6 d FLOP
            # per pair in bf16; split TF32: 12 d in float32, 6 d in bf16,
            # whose Q.K^T is one product and P.V two, at the TF32 rate)
            fp32_ms = flops / PEAK_FLOPS["float32"] * 1e3
            op_ms = (flops / PEAK_FLOPS["bfloat16"] if dtype != f32
                     else 3 * flops / PEAK_FLOPS["tf32"]) * 1e3
            split_ms = (1.5 * flops / PEAK_FLOPS["bfloat16"] if sm90
                        else (3 if dtype == f32 else 1.5) * flops
                        / PEAK_FLOPS["tf32"]) * 1e3
            byte_ms = nbytes / PEAK_BYTES * 1e3
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            line.update({
                "ms": _time_ms(torch, lambda: kernel()),
                "plain_ms": _time_ms(torch, plain, iters=5),
                "library_ms": _time_ms(torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, scale=scale,
                    enable_gqa=True)),
                "bound_ms": max(op_ms, byte_ms),
                "bound_by": "operations" if op_ms >= byte_ms else "bytes",
                "boundFloat32Ms": fp32_ms, "boundSplitMs": split_ms,
                "flops": flops, "bytes": nbytes, "visiblePairs": pairs,
            })
            del mask, qt, kt, vt
            picked = {k: line[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "boundFloat32Ms", "boundSplitMs", "splitEmulationUsed")}
            picked.update(max_abs_err=err, dtype=dt,
                          shape=[b, sq, sk, h, kvh, d])
            if "derivedBoundUsed" in line:
                picked["derivedBoundUsed"] = line["derivedBoundUsed"]
            if name == "slice" and dtype == f32:
                entries.setdefault("flash_fwd_tf32x3", {}).update(picked)
            elif name == "train" and dtype == f32:
                entries.setdefault("flash_fwd_tf32x3", {})[
                    "trainShapeFloat32"] = picked
            elif name == "train":
                entries.setdefault("flash_fwd_sm90", {}).update(picked)
            elif name == "classifier":
                # nested, so that the training shape's figures stay the
                # entry's own
                entries.setdefault("flash_fwd_sm90", {})[
                    "classifierShape"] = picked
            elif name == "lm-d12":
                # nested, so that the serving shape's figures stay the
                # entry's own
                entries.setdefault("flash_fwd_tf32x3", {})[
                    "d12Float32" if dtype == f32 else "d12Bfloat16"] = picked
        log.append("kernel " + json.dumps(line))
        del q, k, v, o, lse, ro, rlse, diff
    return entries


def bwd_kernel_phase(torch, log):
    """The backward kernels against flash_bwd_reference on the card, each
    case in fp32 and bf16, on the forward kernel's own (o, lse), by the
    backward's route (:func:`_route`): flash_bwd_dq_sm90 and
    flash_bwd_dkv_sm90 (bf16 at a head_dim that is a multiple of 8),
    flash_bwd_dq_tf32x3 and flash_bwd_dkv_tf32x3 (every other head_dim,
    float32 or bf16). Returns the kernels-line entries: each kernel at
    the training path's shape in its dtype, bf16 for the fit and float32
    for the float32 fit, with the tf32x3 kernels' d-12 figures nested."""
    import torch.nn.functional as F

    from learningorchestra_tpu_torch.ops import attention as attn

    gen = torch.Generator(device="cuda").manual_seed(1)
    # (name, b, sq, sk, h, kvh, d, causal, window, kv_offset, dlse)
    cases = [
        ("train", 8, 2048, 2048, 8, 4, 64, True, 1024, 0, False),
        ("non-causal-ragged-d32", 2, 77, 201, 4, 2, 32, False, 0, 0, False),
        ("mqa", 2, 130, 130, 8, 1, 64, True, 0, 0, False),
        ("offset-empty-rows-dlse-d128", 2, 64, 64, 4, 4, 128, True, 16, 40,
         True),
        # the d-12 LM's micro-step (2 windows of 2048): a head_dim off the
        # multiple of 8 takes the split-TF32 backward in both dtypes
        ("lm-d12", 2, 2048, 2048, 8, 4, 12, True, 1024, 0, False),
        # an odd head_dim (a bf16 row of odd length: loads element by
        # element) with ragged sq and sk under a dlse term
        ("ragged-dlse-d13", 2, 75, 131, 4, 4, 13, False, 0, 0, True),
        # a multiple of 4 but not of 8, between the kernels' widths, GQA
        ("gqa-window-d36", 2, 160, 160, 8, 2, 36, True, 48, 0, False),
        # the classifier's fit (b 128, 512 tokens, d 32, bidirectional);
        # measured in bf16, its dtype
        ("classifier", 128, 512, 512, 8, 4, 32, False, 0, 0, False),
    ]
    # (atol as a share of the case's largest |g|, rtol). Kernel and plain
    # version compute in float32 from the same inputs and (o, lse) and
    # differ in summation order only. The tensor-core dQ and dK/dV are
    # held more tightly: sm90 (bf16 on wgmma) (a) to the derived bound of
    # bf16 P and dS, 2**-8 sum |ds| |k|, 2**-8 sum |ds| |q| and 2**-8 sum
    # p |dO|, and (b) to the float32 tolerance against the plain version
    # with P and dS split into bf16 hi + lo as the kernels split them;
    # tf32x3 in both dtypes (a bf16 input is exact in TF32) to the
    # float32 tolerance against the float32 plain version and against
    # the plain version that splits every product 3xTF32 as the kernels
    # do. sm90 holds bf16 to the bound a bf16 gradient would carry
    # (rtol 1e-2, about one bf16 ulp).
    tols = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-3, 1e-2)}
    routed = {"sm90": ("FLASH_BWD_DQ_SM90_LAUNCHES",
                       "FLASH_BWD_DKV_SM90_LAUNCHES"),
              "tf32x3": ("FLASH_BWD_DQ_TF32X3_LAUNCHES",
                         "FLASH_BWD_DKV_TF32X3_LAUNCHES")}
    entries = {}
    for (name, b, sq, sk, h, kvh, d, causal, window, offset,
         with_dlse) in cases:
        for dtype in (torch.float32, torch.bfloat16):
            def rand(*shape):
                return torch.randn(*shape, device="cuda", generator=gen) \
                    .to(dtype)

            q, k, v = rand(b, sq, h, d), rand(b, sk, kvh, d), \
                rand(b, sk, kvh, d)
            do = rand(b, sq, h, d)
            dlse = torch.randn(b, sq, h, device="cuda", generator=gen) \
                if with_dlse else None
            scale = 1.0 / d ** 0.5
            o, lse = attn._flash_fwd(q, k, v, causal, scale, window, offset)
            delta = attn._bwd_delta(o, do, dlse)
            route = attn._route(q)
            want_route = "sm90" if dtype == torch.bfloat16 and d % 8 == 0 \
                else "tf32x3"
            dq = getattr(attn, f"_flash_bwd_dq_{route}")
            dkv = getattr(attn, f"_flash_bwd_dkv_{route}")
            dq_name, dkv_name = (f"{n}_{route}" for n in (
                "flash_bwd_dq", "flash_bwd_dkv"))
            args = (q, k, v, do, lse, delta, causal, scale, window, offset)

            def dq_kernel():
                return dq(*args)

            def dkv_kernel():
                return dkv(*args)

            def plain(split=False):
                return attn.flash_bwd_reference(
                    q, k, v, o, lse, do, dlse, causal=causal, scale=scale,
                    window=window, kv_offset=offset, tf32x3=split)

            counters = [c for pair in routed.values() for c in pair]
            before = [getattr(attn, c) for c in counters]
            got = (dq_kernel(), *dkv_kernel())
            torch.cuda.synchronize()
            ran = dict(zip(counters, (getattr(attn, c) - n
                                      for c, n in zip(counters, before))))
            want_ran = {c: int(r == route) for r, pair in routed.items()
                        for c in pair}
            if ran != want_ran or route != want_route:
                raise AssertionError(f"flash_bwd {name} {dtype}: dq and "
                                     f"dkv took the {route} route, want "
                                     f"{want_route} (tensor-core launches "
                                     f"{ran})")
            want = plain()
            rel_atol, rtol = tols[torch.float32 if route == "tf32x3"
                                  else dtype]
            # each of dq, dk, dv finite and within atol (rel_atol of the
            # case's largest |g|) + rtol |g| of the float32 plain version
            errs, used = [], []
            for g, w, part in zip(got, want, ("dq", "dk", "dv")):
                if not bool(torch.isfinite(g).all()):
                    raise AssertionError(f"flash_bwd {name} {dtype}: {part} "
                                         f"not finite")
                atol = rel_atol * w.abs().max().item()
                diff = (g - w).abs()
                errs.append(diff.max().item())
                # worst |g - w| / (atol + rtol |w|); <= 1 passes
                used.append((diff / (atol + rtol * w.abs())).max().item())
                if not used[-1] <= 1.0:
                    raise AssertionError(
                        f"flash_bwd {part} {name} {dtype}: exceeds atol "
                        f"{atol} + rtol {rtol} |ref| by {used[-1]}x (max "
                        f"abs err {errs[-1]})")
            empty = int((lse == attn.NEG_INF).sum())
            if offset and not (empty and bool(
                    (got[0][lse == attn.NEG_INF] == 0).all())):
                raise AssertionError(f"{name}: no empty rows, or empty "
                                     f"rows with a non-zero dq")
            dt = str(dtype).split(".")[-1]
            line = {"case": name, "dtype": dt, "route": route,
                    "dqKernel": dq_name, "dkvKernel": dkv_name,
                    "shape": [b, sq, sk, h, kvh, d], "causal": causal,
                    "window": window, "kvOffset": offset, "dlse": with_dlse,
                    "maxAbsErr": dict(zip(("dq", "dk", "dv"), errs)),
                    "relAtol": rel_atol, "rtol": rtol,
                    "tolUsed": dict(zip(("dq", "dk", "dv"), used)),
                    "emptyRows": empty}
            if route == "sm90":
                split = _split_bwd(torch, attn, q, k, v, o, lse, do, dlse,
                                   causal, scale, window, offset)
                checks = {}
                for part, g, w, e, bound in zip(("dq", "dk", "dv"), got,
                                                want, split[:3], split[3:]):
                    floor = 1e-4 * w.abs().max().item()
                    checks[part] = (
                        ((g - w).abs() / (2.0 ** -8 * bound + floor))
                        .max().item(),
                        ((g - e).abs() / (floor + 1e-4 * e.abs()))
                        .max().item())
                del split
                if not all(a <= 1.0 and e <= 1.0
                           for a, e in checks.values()):
                    raise AssertionError(f"flash_bwd sm90 {name}: (bound "
                                         f"used, split emulation used) "
                                         f"{checks}")
                line["derivedBoundUsed"] = {
                    k: c[0] for k, c in checks.items()}
                line["splitEmulationUsed"] = {
                    k: c[1] for k, c in checks.items()}
            else:
                checks = {}
                for part, g, w, e in zip(("dq", "dk", "dv"), got, want,
                                         plain(split=True)):
                    floor = 1e-4 * w.abs().max().item()
                    checks[part] = ((g - e).abs()
                                    / (floor + 1e-4 * e.abs())).max().item()
                if not all(e <= 1.0 for e in checks.values()):
                    raise AssertionError(f"flash_bwd tf32x3 {name}: split "
                                         f"emulation used {checks}")
                line["splitEmulationUsed"] = checks
            # figures nested under the entry, so that the training
            # shape's stay its own
            nest = {"lm-d12": "d12Float32" if dtype == torch.float32
                    else "d12Bfloat16",
                    "classifier": "classifierShape"}.get(name)
            if name == "train" or name == "lm-d12" or (
                    name == "classifier" and dtype == torch.bfloat16):
                pairs = int(_visible_mask(torch, sq, sk, causal, window,
                                          offset, q.device).sum())
                elt = q.element_size()
                ins = (2 * q.numel() + k.numel() + v.numel()) * elt \
                    + 2 * 4 * lse.numel()
                plain_ms = _time_ms(torch, plain, iters=3)
                # library yardstick: the backward of SDPA over the same
                # mask, i.e. its forward+backward less its forward
                mask = _visible_mask(torch, sq, sk, causal, window, offset,
                                     q.device)
                qt, kt, vt = (x.transpose(1, 2).contiguous()
                              .requires_grad_() for x in (q, k, v))
                dot = do.transpose(1, 2).contiguous()

                def sdpa():
                    return F.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=mask, scale=scale,
                        enable_gqa=True)

                def sdpa_fwd_bwd():
                    torch.autograd.grad(sdpa(), (qt, kt, vt), dot)

                with torch.no_grad():
                    sdpa_fwd_ms = _time_ms(torch, sdpa)
                library_ms = _time_ms(torch, sdpa_fwd_bwd) - sdpa_fwd_ms
                # each kernel: its launch, the function's FLOP per visible
                # pair and head-dim column, the same with bf16 inputs on
                # the tensor cores (P and dS split hi + lo, each input
                # whole: 1 + 1 + 2 products for dq, 1 + 1 + 2 + 2 for
                # dK/dV, whether as bf16 on wgmma or as TF32), output
                # elements, the gradients it writes
                for kernel, fn, per_pair, bf16_pair, outs, parts in (
                        (dq_name, dq_kernel, 6.0, 8.0, q.numel(), ("dq",)),
                        (dkv_name, dkv_kernel, 8.0, 12.0,
                         k.numel() + v.numel(), ("dk", "dv"))):
                    work = per_pair * d * pairs * h * b
                    nbytes = ins + 4 * outs
                    byte_ms = nbytes / PEAK_BYTES * 1e3
                    # the least time for the function on these inputs:
                    # bf16 inputs at the card's bf16 rate, float32 ones
                    # as 3xTF32, on every route; beside it, the split
                    # work the route
                    # runs (bf16 P and dS split hi + lo on wgmma, 3xTF32
                    # for float32 inputs, the reduced split for bf16
                    # inputs at the TF32 rate) and float32 at the CUDA
                    # cores' rate
                    fp32_ms = work / PEAK_FLOPS["float32"] * 1e3
                    bf16_work = bf16_pair / per_pair * work
                    split_ms = {
                        "sm90": bf16_work / PEAK_FLOPS["bfloat16"] * 1e3,
                        "tf32x3": (3 * work if dtype == torch.float32
                                   else bf16_work)
                        / PEAK_FLOPS["tf32"] * 1e3}[route]
                    op_ms = (3 * work / PEAK_FLOPS["tf32"]
                             if dtype == torch.float32
                             else work / PEAK_FLOPS["bfloat16"]) * 1e3
                    ms = _time_ms(torch, fn)
                    part = {
                        "ms": ms, "bound_ms": max(op_ms, byte_ms),
                        "bound_by": "operations" if op_ms >= byte_ms
                        else "bytes", "flops": work, "bytes": nbytes,
                        "boundFloat32Ms": fp32_ms, "boundSplitMs": split_ms}
                    figures = dict(
                        ms=ms, plain_ms=plain_ms, bound_ms=part["bound_ms"],
                        bound_by=part["bound_by"], library_ms=library_ms,
                        max_abs_err=max(e for e, p in zip(
                            errs, ("dq", "dk", "dv")) if p in parts),
                        dtype=dt, boundFloat32Ms=fp32_ms,
                        boundSplitMs=split_ms,
                        shape=[b, sq, sk, h, kvh, d],
                        splitEmulationUsed={
                            p: line["splitEmulationUsed"][p]
                            for p in parts})
                    if route == "sm90":
                        figures["derivedBoundUsed"] = {
                            p: line["derivedBoundUsed"][p] for p in parts}
                    if nest:
                        entries.setdefault(kernel, {})[nest] = figures
                    else:
                        entries.setdefault(kernel, {}).update(figures)
                    line[kernel] = part
                line.update(plain_ms=plain_ms, library_ms=library_ms,
                            sdpaForwardMs=sdpa_fwd_ms, visiblePairs=pairs)
                del mask, qt, kt, vt, dot
            log.append("kernel " + json.dumps(line))
            del q, k, v, do, o, lse, delta, got, want
    return entries


def _http(base, method, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + PREFIX + path, data=data,
                                 method=method)
    req.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def _predict_round(base, model: str, prompts, new: int = NEW_TOKENS):
    """``len(prompts)`` concurrent greedy predicts of ``new`` tokens on
    session ``model``: ``(results, client walls, round wall)``, each
    result ``(status, body)``."""
    out = [None] * len(prompts)
    walls = [0.0] * len(prompts)

    def client(i):
        c0 = time.monotonic()
        out[i] = _http(base, "POST", f"/serve/{model}/predict",
                       {"prompt": prompts[i], "maxNewTokens": new})
        walls[i] = time.monotonic() - c0

    t0 = time.monotonic()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    return out, walls, time.monotonic() - t0


def _round_tokens(name: str, out, new: int = NEW_TOKENS) -> list:
    """The tokens of a round's results; raises on a failed predict or a
    token outside the vocabulary."""
    tokens = []
    for i, result in enumerate(out):
        if result is None or result[0] != 200:
            raise AssertionError(f"{name} predict {i}: {result}")
        got = result[1]["tokens"]
        if len(got) != new or not all(
                0 < t < LM_CONFIG["vocab_size"] for t in got):
            raise AssertionError(f"{name} predict {i}: bad tokens {got}")
        tokens.append(got)
    return tokens


def _round_rates(out, walls, new: int = NEW_TOKENS) -> dict:
    """Decode tokens/s of a round (every stream's tokens after the first
    over the longest decode) and its TTFT as each client saw it: the
    request's wall less the decode after the first token."""
    decode_s = max(r[1]["decodeSeconds"] for r in out)
    ttft_ms = sorted((w - r[1]["decodeSeconds"]) * 1e3
                     for w, r in zip(walls, out))
    return {"clientTtftMs": {"p50": ttft_ms[(len(ttft_ms) - 1) // 2],
                             "max": ttft_ms[-1], "all": ttft_ms},
            "maxDecodeSeconds": decode_s,
            "decodeTokensPerSec": len(out) * (new - 1) / decode_s}


def _diverges(name: str, tokens, want) -> None:
    for i, (got, ref) in enumerate(zip(tokens, want)):
        ref = [int(t) for t in ref]
        if got != ref:
            first = next(j for j, (a, b) in enumerate(zip(got, ref))
                         if a != b)
            raise AssertionError(f"{name} predict {i} diverges from "
                                 f"solo generate at token {first}")


def slice_phase(torch, log, home, yard):
    """REST create -> 4 concurrent predicts -> stats -> delete. Returns
    the kernel launches of the serving path; leaves the prompts, the
    solo ``generate`` tokens and the slot session's tokens in ``yard``
    for the paged phase."""
    import numpy as np

    from learningorchestra_tpu_torch.config import Config
    from learningorchestra_tpu_torch.models import weights
    from learningorchestra_tpu_torch.models.transformer import \
        LanguageModel
    from learningorchestra_tpu_torch.ops import attention as attn
    from learningorchestra_tpu_torch.services.context import ServiceContext
    from learningorchestra_tpu_torch.services.server import RestServer

    state = weights.params_from_flax(weights.init_params(LM_CONFIG, seed=0))
    lm = LanguageModel(**LM_CONFIG, device="cuda")
    lm.set_params(state)
    ctx = ServiceContext(Config(home=home), device="cuda")
    ctx.artifacts.save(lm, "lm", "train/tensorflow")
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(1, LM_CONFIG["vocab_size"],
                                             size=n)]
               for n in PROMPT_LENS]
    server = RestServer(port=0, context=ctx).start()
    rounds = []
    try:
        _reset_launches(attn)
        status, body = _http(server.base_url, "POST", "/serve/lm", {
            "type": "lm", "maxSlots": 4, "cacheLen": 2048,
            "temperature": 0.0})
        if status != 201:
            raise AssertionError(f"create: {status} {body}")
        # round 1 pays first use on the session's worker thread (library
        # handles, first launches); round 2 sends the same requests warm
        for name in ("cold", "warm"):
            out, walls, wall = _predict_round(server.base_url, "lm",
                                              prompts)
            status, stats = _http(server.base_url, "GET", "/serve/lm")
            if status != 200:
                raise AssertionError(f"stats: {status} {stats}")
            rounds.append((name, out, walls, wall, stats))
        launches = _launches(attn)
        status, deleted = _http(server.base_url, "DELETE", "/serve/lm")
        if status != 200 or deleted.get("deleted") is not True:
            raise AssertionError(f"delete: {status} {deleted}")
    finally:
        server.stop()

    need = LM_CONFIG["n_layers"] * len(prompts) * len(rounds)
    if launches["flash_fwd_tf32x3"] < need:
        raise AssertionError(f"flash_fwd_tf32x3 launched "
                             f"{launches['flash_fwd_tf32x3']} times on the "
                             f"serving path; {len(prompts) * len(rounds)} "
                             f"prefills of {LM_CONFIG['n_layers']} layers "
                             f"need {need}")
    if any(n for k, n in launches.items() if k != "flash_fwd_tf32x3"):
        raise AssertionError(f"serving (float32) ran a kernel other than "
                             f"flash_fwd_tf32x3: {launches}")
    solos = [lm.generate([p], max_new_tokens=NEW_TOKENS)[0][len(p):]
             for p in prompts]
    report = []
    for name, out, walls, wall, stats in rounds:
        tokens = _round_tokens(name, out)
        _diverges(name, tokens, solos)
        # this round's own TTFT (session stats pool every round's)
        report.append({
            "round": name, "wallSeconds": wall, **_round_rates(out, walls),
            "statsSoFar": {k: stats[k] for k in (
                "ttft", "roles", "perf", "tokensTotal")}})
    yard.update(prompts=prompts, solos=[[int(t) for t in x] for x in solos],
                slotTokens=tokens)
    report.append(_decode_profile(torch, lm, prompts))
    # the prefill logits through the kernel against the dense path
    dense = LanguageModel(**LM_CONFIG, attention="dot", device="cuda")
    dense.set_params(state)
    tokens = torch.tensor([prompts[-1]], device="cuda")
    with torch.inference_mode():
        got = lm.module(tokens)
        want = dense.module(tokens)
    if not bool(torch.isfinite(got).all()) or \
            got.shape != (1, PROMPT_LENS[-1], LM_CONFIG["vocab_size"]):
        raise AssertionError("prefill logits not finite or misshapen")
    logit_err = (got - want).abs().max().item()
    if not logit_err <= 1e-3:
        raise AssertionError(f"flash vs dot prefill logits: {logit_err}")
    log.append("slice " + json.dumps({
        "prompts": list(PROMPT_LENS), "newTokens": NEW_TOKENS,
        "launches": launches, "tokensEqualSolo": True,
        "prefillLogitsMaxAbsErrVsDot": logit_err, "rounds": report}))
    return launches


# the paged phase: a pool of 16-token pages at the slot session's bytes
# (4 slots x 2048 rows + the trash page = 513 pages), and 16 streams of
# 64-448 prompt tokens on it
PAGE_LEN, PAGED_STREAMS, PAGED_PROMPTS = 16, 16, (64, 448)
# the prompt that shares the 1367-token prompt's first 64 pages
SHARED_PREFIX = 1024


def _create(base, model: str, body: dict) -> dict:
    status, resp = _http(base, "POST", f"/serve/{model}", body)
    if status != 201:
        raise AssertionError(f"create {body}: {status} {resp}")
    return resp


def _agreement(tokens, want) -> dict:
    """Greedy agreement of a round with the exact session's: streams
    equal in full, tokens equal in place, and each stream's first
    differing position (None where it never differs)."""
    first = [next((j for j, (a, b) in enumerate(zip(got, ref)) if a != b),
                  None) for got, ref in zip(tokens, want)]
    same = sum(a == b for got, ref in zip(tokens, want)
               for a, b in zip(got, ref))
    return {"streamsEqual": sum(f is None for f in first),
            "tokensEqualFrac": same / sum(len(t) for t in want),
            "firstDiff": first}


def paged_phase(torch, log, home, serve_yard):
    """Paged and quantized LM serving over REST on the card, float32 (every
    prefill on flash_fwd_tf32x3). (a) ``kv: "paged"`` with the slot
    session's shape (4 slots, cacheLen 2048, 16-token pages, the pool
    sized to the slot cache's bytes): the serving phase's 4 prompts
    (after a first-use round of other prompts) must give the slot
    session's and solo ``generate``'s tokens, 8 forward launches a
    prefill. (b) The 1500-token prompt again is an exact prefix hit (no
    launch, the same tokens); a prompt sharing the 1367-token prompt's
    first 1024 tokens reuses its 64 pages and runs its prefill. (c) 16
    slots on the same 513 pages: 16 prompts of 64-448 tokens all decode
    at once (the slot session at these bytes holds 4), each equal to
    solo. (d) int8 KV with int8 weights, and fp8 weights: drift stamped
    at create (int8 within 0.05), bytes per token, greedy agreement with
    (a), and with LO_SERVE_DRIFT_MAX at 1e-9 a session that degrades to
    exact and answers (a)'s tokens. Returns the launches of (a) and of
    the exact hit as paths "paged" and "pagedPrefixHit"."""
    import numpy as np

    from learningorchestra_tpu_torch.config import Config
    from learningorchestra_tpu_torch.models import weights
    from learningorchestra_tpu_torch.models.transformer import \
        LanguageModel
    from learningorchestra_tpu_torch.ops import attention as attn
    from learningorchestra_tpu_torch.services.context import ServiceContext
    from learningorchestra_tpu_torch.services.server import RestServer

    t0 = time.monotonic()
    state = weights.params_from_flax(weights.init_params(LM_CONFIG, seed=0))
    lm = LanguageModel(**LM_CONFIG, device="cuda")
    lm.set_params(state)
    ctx = ServiceContext(Config(home=home), device="cuda")
    ctx.artifacts.save(lm, "lm", "train/tensorflow")
    prompts, solos = serve_yard["prompts"], serve_yard["solos"]
    vocab = LM_CONFIG["vocab_size"]
    rng = np.random.default_rng(1)
    first_use = [[int(t) for t in rng.integers(1, vocab, size=n)]
                 for n in PROMPT_LENS]
    shared = prompts[2][:SHARED_PREFIX] + [
        int(t) for t in rng.integers(1, vocab, size=476)]
    many = [[int(t) for t in rng.integers(1, vocab, size=n)]
            for n in rng.integers(PAGED_PROMPTS[0], PAGED_PROMPTS[1] + 1,
                                  size=PAGED_STREAMS)]

    def solo(p):
        return [int(t) for t in
                lm.generate([p], max_new_tokens=NEW_TOKENS)[0][len(p):]]

    shared_solo, many_solo = solo(shared), [solo(p) for p in many]
    paged = {"type": "lm", "kv": "paged", "maxSlots": 4, "cacheLen": 2048,
             "pageLen": PAGE_LEN, "temperature": 0.0}
    server = RestServer(port=0, context=ctx).start()
    base = server.base_url
    report: dict = {"prompts": list(PROMPT_LENS), "newTokens": NEW_TOKENS}
    try:
        # (a) paged against slot and solo
        resp = _create(base, "lm", paged)
        if resp["kv"]["pagesTotal"] != 4 * 2048 // PAGE_LEN or \
                resp["kv"]["dtype"] != "bf16":
            raise AssertionError(f"paged pool: {resp['kv']}")
        exact_bpt = resp["kv"]["bytesPerToken"]
        _round_tokens("paged first use", _predict_round(base, "lm",
                                                        first_use)[0])
        _reset_launches(attn)
        out, walls, wall = _predict_round(base, "lm", prompts)
        launches = _launches(attn)
        exact = _round_tokens("paged", out)
        _diverges("paged", exact, solos)
        if exact != serve_yard["slotTokens"]:
            raise AssertionError("paged tokens differ from the slot "
                                 "session's")
        need = LM_CONFIG["n_layers"] * len(prompts)
        if launches["flash_fwd_tf32x3"] != need or any(
                n for k, n in launches.items() if k != "flash_fwd_tf32x3"):
            raise AssertionError(f"paged prefills launched {launches}; "
                                 f"{need} flash_fwd_tf32x3 expected")
        report["a"] = {"launches": launches, "tokensEqualSolo": True,
                       "tokensEqualSlot": True, "wallSeconds": wall,
                       "bytesPerToken": exact_bpt,
                       **_round_rates(out, walls)}

        # (b) an exact prefix hit, then a shared prefix
        _reset_launches(attn)
        out, walls, _ = _predict_round(base, "lm", prompts[3:])
        hit_launches = _launches(attn)
        _diverges("prefix hit", _round_tokens("prefix hit", out),
                  solos[3:])
        hit_ttft = _round_rates(out, walls)["clientTtftMs"]["p50"]
        if any(hit_launches.values()):
            raise AssertionError(f"an exact prefix hit launched "
                                 f"{hit_launches}")
        before = _http(base, "GET", "/serve/lm")[1]["kv"]["prefix"]
        _reset_launches(attn)
        out, _, _ = _predict_round(base, "lm", [shared])
        shared_launches = _launches(attn)
        _diverges("shared prefix", _round_tokens("shared prefix", out),
                  [shared_solo])
        prefix = _http(base, "GET", "/serve/lm")[1]["kv"]["prefix"]
        reused = prefix["pagesReused"] - before["pagesReused"]
        if prefix["hitsPartial"] != before["hitsPartial"] + 1 or \
                reused != SHARED_PREFIX // PAGE_LEN or \
                shared_launches["flash_fwd_tf32x3"] != LM_CONFIG["n_layers"]:
            raise AssertionError(f"shared prefix: {reused} pages reused, "
                                 f"{prefix}, {shared_launches}")
        report["b"] = {"exactHitLaunches": hit_launches,
                       "exactHitTtftMs": hit_ttft,
                       "sharedPagesReused": reused,
                       "sharedLaunches": shared_launches, "prefix": prefix}
        _http(base, "DELETE", "/serve/lm")

        # (c) 16 streams on the same bytes
        resp = _create(base, "lm", dict(paged, maxSlots=PAGED_STREAMS,
                                        pages=4 * 2048 // PAGE_LEN + 1))
        _round_tokens("16 streams first use", _predict_round(
            base, "lm", first_use[:1])[0])
        out, walls, wall = _predict_round(base, "lm", many)
        _diverges("16 streams", _round_tokens("16 streams", out), many_solo)
        stats = _http(base, "GET", "/serve/lm")[1]
        if stats["peakActiveSlots"] != PAGED_STREAMS:
            raise AssertionError(f"16 streams: at most "
                                 f"{stats['peakActiveSlots']} decoded at "
                                 f"once")
        report["c"] = {"streams": PAGED_STREAMS,
                       "promptLens": [len(p) for p in many],
                       "peakActiveSlots": stats["peakActiveSlots"],
                       "pagesTotal": stats["kv"]["pagesTotal"],
                       "tokensEqualSolo": True, "wallSeconds": wall,
                       **_round_rates(out, walls)}
        _http(base, "DELETE", "/serve/lm")

        # (d) quantized sessions; the gate off (max 0) measures fp8 as it
        # serves, 1e-9 forces a breach
        report["d"] = {}
        for name, extra, drift_max in (
                ("int8", {"kvDtype": "int8", "weights": "int8"}, None),
                ("fp8", {"weights": "fp8"}, None),
                ("fp8Ungated", {"weights": "fp8"}, 0.0),
                ("forcedBreach", {"kvDtype": "int8", "weights": "int8"},
                 1e-9)):
            default_max = ctx.config.serve_drift_max
            if drift_max is not None:
                ctx.config.serve_drift_max = drift_max
            try:
                resp = _create(base, "lm", dict(paged, **extra))
            finally:
                ctx.config.serve_drift_max = default_max
            _round_tokens(f"{name} first use",
                          _predict_round(base, "lm", first_use)[0])
            out, walls, _ = _predict_round(base, "lm", prompts)
            tokens = _round_tokens(name, out)
            row = {"drift": resp.get("drift"), "quant": resp["quant"],
                   "kv": {k: resp["kv"][k] for k in ("dtype",
                                                     "bytesPerToken")},
                   "exactBytesPerToken": exact_bpt,
                   "weights": resp["weights"],
                   "agreement": _agreement(tokens, exact),
                   **_round_rates(out, walls)}
            degraded = resp["quant"]["degrades"] > 0
            if name == "int8" and (degraded or not resp["drift"]["value"]
                                   <= 0.05):
                raise AssertionError(f"int8 session drift: {row}")
            if name == "forcedBreach" and not degraded:
                raise AssertionError(f"a drift max of 1e-9 did not "
                                     f"degrade: {row}")
            if degraded:
                if resp["kv"]["dtype"] != "bf16" or \
                        resp["weights"]["dtype"] != "bf16":
                    raise AssertionError(f"{name} degraded to {row}")
                _diverges(f"{name} (degraded)", tokens, solos)
            report["d"][name] = row
            _http(base, "DELETE", "/serve/lm")
    finally:
        server.stop()
    report["decodeProfile"] = _decode_profile(torch, lm, prompts, paged=True)
    report["seconds"] = time.monotonic() - t0
    log.append("paged " + json.dumps(report))
    return {"paged": launches, "pagedPrefixHit": hit_launches}


def _decode_profile(torch, lm, prompts, paged: bool = False,
                    steps: int = 8):
    """Where a warm decode step's time goes: ``steps`` steps of 4 filled
    slots (``paged``: 4 streams over a pool of 16-token pages, each
    stream's 128 pages gathered) under ``torch.profiler``, with the host
    wall per step and the top operators by device and by host time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import numpy as np

    if paged:
        pages = 2048 // PAGE_LEN
        step, prefill_for, join_paged, _, _ = lm.serve_fns_paged(
            4, 2048, PAGE_LEN, 4 * pages + 1, 0.0)
        cache = lm.serve_cache_paged(4 * pages + 1, PAGE_LEN)
        tables = 1 + torch.arange(4 * pages, device="cuda").reshape(4, pages)
    else:
        step, prefill_for, join = lm.serve_fns(4, 2048, 0.0)
        cache = lm.serve_cache(4, 2048)
    col = np.zeros(4, np.int64)
    tok = np.zeros((4, 1), np.int64)
    for slot, prompt in enumerate(prompts):
        tokens = torch.tensor([prompt], device="cuda")
        if paged:
            nxt, _, pcache = prefill_for(len(prompt))(tokens, 0)
            join_paged(cache, pcache,
                       tables[slot, :-(-len(prompt) // PAGE_LEN)], 0)
        else:
            nxt, pcache = prefill_for(len(prompt))(tokens, 0)
            join(cache, pcache, slot)
        tok[slot, 0], col[slot] = int(nxt[0]), len(prompt)
    seeds = np.zeros(4, np.int64)

    def run(n):
        for _ in range(n):
            if paged:
                nxt = step(cache, tok, col, tables, seeds).cpu().numpy()
            else:
                nxt = step(cache, tok, col, seeds).cpu().numpy()
            tok[:, 0] = nxt
            col[:] += 1

    run(4)
    t0 = time.monotonic()
    run(steps)
    wall_ms = (time.monotonic() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(steps)
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]

    def top(rows, attr):
        rows = sorted(rows, key=lambda e: getattr(e, attr), reverse=True)
        return [[e.key[:80], round(getattr(e, attr) / steps / 1e3, 4),
                 e.count / steps] for e in rows[:10]]

    report = {"round": "pagedDecodeProfile" if paged else "decodeProfile",
              "steps": steps,
              "hostWallMsPerStep": wall_ms,
              "deviceBusyMsPerStep": sum(
                  e.self_device_time_total for e in kernels) / steps / 1e3,
              "kernelLaunchesPerStep": sum(e.count for e in kernels) / steps,
              "topKernelsMs": top(kernels, "self_device_time_total"),
              "topHostMs": top(events, "self_cpu_time_total")}
    # a dropped profile leaves some 220,000 objects in reference cycles:
    # collect them here, or a generation-2 collection lands in a later
    # timed round (0.34 s of the paged phase's 16-stream TTFT on the card)
    del prof, events, kernels
    gc.collect()
    return report


def _successor_windows(np, n: int, seq: int, seed: int):
    """``n`` windows of ``seq`` tokens of the stream where id t is
    followed by t % 63 + 1; each window starts at an id drawn from
    ``seed``."""
    start = np.random.default_rng(seed).integers(1, 64, size=n)
    return ((start[:, None] - 1 + np.arange(seq)[None, :]) % 63 + 1) \
        .astype(np.int32)


def _domain_windows(np, n: int, seq: int, seed: int):
    """``n`` windows of ``seq`` tokens of a second stream, where id t is
    followed by (t + 6) % 97 + 1; each window starts at an id drawn from
    ``seed``."""
    start = np.random.default_rng(seed).integers(1, 98, size=n)
    return ((start[:, None] - 1 + 7 * np.arange(seq)[None, :]) % 97 + 1) \
        .astype(np.int32)


def _marker_rows(np, n: int, seq: int, vocab: int, seed: int):
    """``n`` rows of ``seq`` tokens drawn from [2, vocab) with lengths
    64..seq padded with 0, and labels: whether the marker id 1 appears
    anywhere in the row (a task only bidirectional attention into the
    pool can see; tests/test_transformer.py's classifier task)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(2, vocab, size=(n, seq)).astype(np.int32)
    lengths = rng.integers(64, seq + 1, size=n)
    y = rng.integers(0, 2, size=n).astype(np.int32)
    pos = (rng.random(n) * lengths).astype(np.int64)
    rows = np.arange(n)[y == 1]
    x[rows, pos[y == 1]] = 1
    x[np.arange(seq)[None, :] >= lengths[:, None]] = 0
    return x, y


def _float32_fit_window(torch, lm, x, log) -> dict:
    """The fit of the train phase in float32 (``LO_COMPUTE_DTYPE``): one
    optimizer step of first use, 2 timed steps (host clock to a
    synchronize), then the same 2 batches again under the profiler, each
    step of TRAIN_BATCH windows at grad_accum TRAIN_ACCUM. The params are restored after it,
    so the artifact holds exactly the bf16 fit's steps. Logs the
    ``trainFloat32`` line and returns the kernel launches of the 2 timed
    steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import numpy as np

    from learningorchestra_tpu_torch.ops import attention as attn

    os.environ["LO_COMPUTE_DTYPE"] = "float32"
    lm._engine = None
    try:
        eng = lm._get_engine()
        if eng._compute_dtype != torch.float32 or \
                eng._grad_accum != TRAIN_ACCUM:
            raise AssertionError("the float32 window must run the fit's "
                                 "float32 engine at its grad_accum")
        params = lm._master_params()
        saved = {k: p.detach().clone() for k, p in params.items()}
        tstate = eng.init_state(params)
        batches = [eng._to_device(b, lm.device) for b in
                   lm._batcher(x[:3 * TRAIN_BATCH], TRAIN_BATCH).epoch(0)]
        eng._train_step_body(tstate, batches[0], 0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches(attn)
        t0 = time.monotonic()
        losses = [eng._train_step_body(tstate, batch, 0)["loss"]
                  for batch in batches[1:3]]
        torch.cuda.synchronize()
        step_ms = (time.monotonic() - t0) / 2 * 1e3
        launches = _launches(attn)
        peak_bytes = torch.cuda.max_memory_allocated()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            w0 = time.monotonic()
            for batch in batches[1:3]:
                eng._train_step_body(tstate, batch, 0)
            torch.cuda.synchronize()
            window_ms = (time.monotonic() - w0) * 1e3
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(saved[k])
        losses = [float(s) / float(c) for s, c in losses]
        del saved, tstate, batches
    finally:
        os.environ["LO_COMPUTE_DTYPE"] = "bfloat16"
        lm._engine = None
    if not all(np.isfinite(losses)):
        raise AssertionError(f"float32 window losses {losses}")
    need = LM_CONFIG["n_layers"] * TRAIN_ACCUM * 2
    want = dict.fromkeys(COUNTERS, 0)
    want.update(flash_fwd_tf32x3=need, flash_bwd_dq_tf32x3=need,
                flash_bwd_dkv_tf32x3=need)
    if launches != want:
        raise AssertionError(f"kernel launches in the float32 window "
                             f"{launches}; 2 steps of {TRAIN_ACCUM} "
                             f"micro-batches of {LM_CONFIG['n_layers']} "
                             f"layers need {want}")
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    per_step = {name: sum(e.self_device_time_total for e in kernels
                          if f"{name}_kernel" in e.key) / 2e3
                for name in COUNTERS}
    top = [[e.key[:80], e.self_device_time_total / 2e3, e.count / 2]
           for e in sorted(kernels, key=lambda e: e.self_device_time_total,
                           reverse=True)[:10]]
    del prof, kernels
    gc.collect()  # the profile's cycles (see _decode_profile)
    log.append("trainFloat32 " + json.dumps({
        "computeDtype": "float32", "optimizerSteps": 2,
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "gradAccum": TRAIN_ACCUM,
        "stepMs": step_ms,
        "trainTokensPerSec": TRAIN_BATCH * TRAIN_SEQ / step_ms * 1e3,
        "losses": losses, "launches": launches,
        "launchesPerStep": {k: n / 2 for k, n in launches.items() if n},
        "maxMemoryAllocatedBytes": peak_bytes,
        "profile": {"steps": 2, "windowMs": window_ms,
                    "deviceBusyMs": busy_ms,
                    "idleShare": 1.0 - busy_ms / window_ms,
                    "kernelMsPerStep": {k: v for k, v in per_step.items()
                                        if v},
                    "topKernelsMsPerStep": top}}))
    return launches


def _profiled_window(torch, lm, x) -> dict:
    """A profiler window of 2 optimizer steps of ``lm``'s fit engine on
    the first windows of ``x`` (after one step of first use): wall,
    device busy time, idle share and kernel time per step. The params
    are restored after it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    eng = lm._get_engine()
    params = lm._master_params()
    saved = {k: p.detach().clone() for k, p in params.items()}
    tstate = eng.init_state(params)
    batches = [eng._to_device(b, lm.device) for b in
               lm._batcher(x[:3 * TRAIN_BATCH], TRAIN_BATCH).epoch(0)]
    eng._train_step_body(tstate, batches[0], 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        w0 = time.monotonic()
        for batch in batches[1:]:
            eng._train_step_body(tstate, batch, 0)
        torch.cuda.synchronize()
        window_ms = (time.monotonic() - w0) * 1e3
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(saved[k])
    del saved, tstate, batches
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    per_step = {name: sum(e.self_device_time_total for e in kernels
                          if f"{name}_kernel" in e.key) / 2e3
                for name in COUNTERS}
    top = [[e.key[:80], e.self_device_time_total / 2e3, e.count / 2]
           for e in sorted(kernels, key=lambda e: e.self_device_time_total,
                           reverse=True)[:10]]
    del prof, kernels
    gc.collect()  # the profile's cycles (see _decode_profile)
    return {"steps": 2, "windowMs": window_ms, "deviceBusyMs": busy_ms,
            "idleShare": 1.0 - busy_ms / window_ms,
            "kernelMsPerStep": per_step, "topKernelsMsPerStep": top}


def _grads_vs_dot(torch, path, config, init, dtype, limit, x) -> dict:
    """One micro-step of ``x`` in ``dtype`` through the split-TF32
    kernels (one launch of each per layer) against the same step on the
    dense path (plain autograd), both from ``init``: the launches and the
    worst per-tensor relative L2 error, which must be within ``limit``
    (None records it only)."""
    import numpy as np

    from learningorchestra_tpu_torch.models.transformer import \
        LanguageModel
    from learningorchestra_tpu_torch.ops import attention as attn
    from learningorchestra_tpu_torch.runtime.data import MASK_KEY

    kernels = ("flash_fwd_tf32x3", "flash_bwd_dq_tf32x3",
               "flash_bwd_dkv_tf32x3")
    os.environ["LO_COMPUTE_DTYPE"] = dtype
    out, grads = {}, {}
    try:
        for impl in ("flash", "dot"):
            model = LanguageModel(**config, attention=impl, device="cuda")
            model.set_params(init)
            feng = model._get_engine()
            if feng._compute_dtype != getattr(torch, dtype):
                raise AssertionError(f"the gradient check must run in "
                                     f"{dtype}")
            batch = feng._to_device(
                {"x": x, MASK_KEY: np.ones(len(x), np.float32)},
                model.device)
            _reset_launches(attn)
            g, _ = feng._micro_grads(model._master_params(), batch, 0)
            ran = _launches(attn)
            want_ran = dict.fromkeys(COUNTERS, 0)
            if impl == "flash":
                want_ran.update(dict.fromkeys(kernels, config["n_layers"]))
            if ran != want_ran:
                raise AssertionError(f"{path} {impl} gradient step launched "
                                     f"{ran}, want {want_ran}")
            if not all(bool(torch.isfinite(t).all()) for t in g.values()):
                raise AssertionError(f"{path} {impl}: gradients not finite")
            if impl == "flash":
                out["launches"] = ran
            grads[impl] = g
            del model, feng, batch
    finally:
        os.environ["LO_COMPUTE_DTYPE"] = "bfloat16"
    rel = {k: ((grads["flash"][k].float() - grads["dot"][k].float())
               .norm() / grads["dot"][k].float().norm().clamp_min(1e-30))
           .item() for k in grads["dot"]}
    worst = max(rel, key=rel.get)
    if limit is not None and not rel[worst] <= limit:
        raise AssertionError(f"{path}: kernel vs dense gradient of "
                             f"{worst}: relative L2 error {rel[worst]}")
    out["relL2VsDot"] = {"max": rel[worst], "worst": worst}
    return out


def train_phase(torch, log, home, yard):
    """fit on the card -> checks -> a profiled 2-step window -> a float32
    window of the same fit -> kernel-vs-dense gradients -> save, serve
    over REST, predict. Returns the kernel launches of each path it
    drove: the bf16 fit, the float32 fit window, the two float32
    gradient steps and the d-12 LM's bf16 gradient step. Leaves the
    fit's windows, epoch losses and trained model in ``yard``, the
    pipeline phase's yardstick."""
    import numpy as np

    from learningorchestra_tpu_torch.config import Config
    from learningorchestra_tpu_torch.models import weights
    from learningorchestra_tpu_torch.models.transformer import \
        LanguageModel
    from learningorchestra_tpu_torch.ops import attention as attn
    from learningorchestra_tpu_torch.services.context import ServiceContext
    from learningorchestra_tpu_torch.services.server import RestServer

    os.environ["LO_COMPUTE_DTYPE"] = "bfloat16"
    state = weights.params_from_flax(weights.init_params(LM_CONFIG, seed=0))
    x = _successor_windows(np, TRAIN_WINDOWS, TRAIN_SEQ, seed=0)
    lm = LanguageModel(**LM_CONFIG, device="cuda")
    lm.set_params(state)
    if lm._get_engine()._compute_dtype != torch.bfloat16:
        raise AssertionError("the training path must compute in bf16")
    steps = TRAIN_EPOCHS * TRAIN_WINDOWS // TRAIN_BATCH
    micro = steps * TRAIN_ACCUM
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches(attn)
    t0 = time.monotonic()
    hist = lm.fit(x, batch_size=TRAIN_BATCH, epochs=TRAIN_EPOCHS,
                  grad_accum=TRAIN_ACCUM).history
    fit_s = time.monotonic() - t0
    launches = _launches(attn)
    peak_bytes = torch.cuda.max_memory_allocated()
    losses = hist["loss"]
    if not all(np.isfinite(losses)) or len(losses) != TRAIN_EPOCHS:
        raise AssertionError(f"training losses {losses}")
    if not losses[1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    if not all(abs(a - b) <= 0.01 * b
               for a, b in zip(losses, CUDA_CORE_LOSSES)):
        raise AssertionError(f"epoch losses {losses} are not within 1% of "
                             f"the CUDA-core kernels' {CUDA_CORE_LOSSES}")
    # bf16: the forward, dq and dK/dV take the tensor-core route, every
    # time
    need = LM_CONFIG["n_layers"] * micro
    want = dict.fromkeys(COUNTERS, 0)
    want.update(flash_fwd_sm90=need, flash_bwd_dq_sm90=need,
                flash_bwd_dkv_sm90=need)
    if launches != want:
        raise AssertionError(f"kernel launches during fit {launches}; "
                             f"{micro} micro-batches of "
                             f"{LM_CONFIG['n_layers']} layers need {want}")
    # steady-state step time: the second epoch, after first use
    step_ms = hist["epochSeconds"][1] / (steps // TRAIN_EPOCHS) * 1e3
    tokens_per_s = TRAIN_WINDOWS * TRAIN_SEQ / hist["epochSeconds"][1]

    # a profiled window of 2 optimizer steps; the params are restored
    # after it, so the artifact holds exactly the fit's 8 steps
    window = _profiled_window(torch, lm, x)

    f32_fit = _float32_fit_window(torch, lm, x, log)

    # one micro-step of 2 windows through the split-TF32 kernels, one
    # launch of each per layer, against the same step on the dense path
    # (plain autograd): in float32 for the tutorial LM (head_dim 64) and
    # the d-12 LM (the width-16 variants), each within 1e-4; in bf16 for
    # the d-12 LM, finite, its error against the bf16 dense path recorded
    # only (the kernel phase holds the kernels' numbers)
    f32_grad = {}
    for path, config, dtype, limit in (
            ("trainFloat32Grad", LM_CONFIG, "float32", 1e-4),
            ("trainFloat32GradD12", D12_CONFIG, "float32", 1e-4),
            ("trainBf16GradD12", D12_CONFIG, "bfloat16", None)):
        init = state if config is LM_CONFIG else weights.params_from_flax(
            weights.init_params(config, seed=0))
        f32_grad[path] = _grads_vs_dot(torch, path, config, init, dtype,
                                       limit, x[:2])

    # the trained artifact, reloaded and served over REST
    ctx = ServiceContext(Config(home=home), device="cuda")
    ctx.artifacts.save(lm, "trained", "train/tensorflow")
    loaded = ctx.artifacts.load("trained")
    if loaded.history != lm.history:
        raise AssertionError("the artifact lost the training history")
    prompt = [int(t) for t in x[0, :256]]
    server = RestServer(port=0, context=ctx).start()
    try:
        status, body = _http(server.base_url, "POST", "/serve/trained", {
            "type": "lm", "maxSlots": 2, "cacheLen": 512,
            "temperature": 0.0})
        if status != 201:
            raise AssertionError(f"create: {status} {body}")
        status, out = _http(server.base_url, "POST",
                            "/serve/trained/predict",
                            {"prompt": prompt, "maxNewTokens": NEW_TOKENS})
        if status != 200:
            raise AssertionError(f"predict: {status} {out}")
        _http(server.base_url, "DELETE", "/serve/trained")
    finally:
        server.stop()
    want = [int(t) for t in loaded.generate(
        [prompt], max_new_tokens=NEW_TOKENS)[0][len(prompt):]]
    if out["tokens"] != want:
        raise AssertionError(f"served tokens {out['tokens']} differ from "
                             f"the reloaded model's generate {want}")
    follows = sum(t == p % 63 + 1 for p, t in
                  zip([prompt[-1]] + want[:-1], want)) / len(want)
    yard.update(x=x, losses=list(losses), lm=lm)
    log.append("train " + json.dumps({
        "config": LM_CONFIG, "windows": TRAIN_WINDOWS, "seq": TRAIN_SEQ,
        "batch": TRAIN_BATCH, "epochs": TRAIN_EPOCHS,
        "gradAccum": TRAIN_ACCUM, "optimizerSteps": steps,
        "microBatches": micro, "computeDtype": "bfloat16",
        "history": hist, "fitSeconds": fit_s, "launches": launches,
        "stepMs": step_ms, "trainTokensPerSec": tokens_per_s,
        "maxMemoryAllocatedBytes": peak_bytes,
        "profile": window,
        "f32GradRelL2VsDot": f32_grad["trainFloat32Grad"]["relL2VsDot"],
        "f32GradLaunches": f32_grad["trainFloat32Grad"]["launches"],
        "f32GradD12": f32_grad["trainFloat32GradD12"],
        "bf16GradD12": f32_grad["trainBf16GradD12"],
        "servedTokensEqualGenerate": True,
        "servedSuccessorShare": follows}))
    return {"train": launches, "trainFloat32": f32_fit,
            **{path: c["launches"] for path, c in f32_grad.items()}}


def _poll(base, path, timeout: float = 600.0,
          interval: float = 0.25) -> dict:
    """Polls ``path`` every ``interval`` seconds (the JAX client's
    default) until ``finished``; the metadata document then. A job that
    records an exception fails the phase with its document."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        status, body = _http(base, "GET", path + "?limit=1")
        if status != 200:
            raise AssertionError(f"GET {path}: {status} {body}")
        if body["metadata"]["finished"]:
            return body["metadata"]
        if body["metadata"].get("status") == "deadLettered":
            failed = _http(base, "GET", path)[1]["result"][-1]
            raise AssertionError(f"job {path} failed: {failed}")
        time.sleep(interval)
    raise AssertionError(f"{path} did not finish in {timeout} s")


def pipeline_phase(torch, log, home, yard):
    """The tutorial's LM workflow over HTTP against a RestServer on the
    card, held against the train phase: ingest the train phase's 64
    windows as a CSV, create the LM through the JAX package's module
    path, fit it (8 optimizer steps, bf16), evaluate, generate, serve
    the trained artifact, and check that refused and failed requests
    are recorded. Returns the kernel launches of the REST fit, evaluate
    and generate."""
    import numpy as np

    from learningorchestra_tpu_torch.catalog.store import Table
    from learningorchestra_tpu_torch.config import Config
    from learningorchestra_tpu_torch.ops import attention as attn
    from learningorchestra_tpu_torch.runtime.data import dataframe_to_arrays
    from learningorchestra_tpu_torch.services.context import ServiceContext
    from learningorchestra_tpu_torch.services.server import RestServer

    # the train phase's float32 windows changed it; a REST model builds
    # its engine from it
    os.environ["LO_COMPUTE_DTYPE"] = "bfloat16"
    x = yard["x"]
    csv_path = os.path.join(home, "corpus.csv")
    with open(csv_path, "w") as f:
        f.write(",".join(f"t{i}" for i in range(x.shape[1])) + "\n")
        for row in x:
            f.write(",".join(map(str, row.tolist())) + "\n")
    ctx = ServiceContext(Config(home=os.path.join(home, "lo")),
                         device="cuda")
    server = RestServer(port=0, context=ctx).start()
    base = server.base_url
    steps = TRAIN_EPOCHS * TRAIN_WINDOWS // TRAIN_BATCH
    launches = {}

    def post(path, body, want=201):
        status, out = _http(base, "POST", path, body)
        if status != want:
            raise AssertionError(f"POST {path}: {status} {out}")
        return out

    job_seconds = {}

    def job(verb, name, parent, method, params):
        """POST a job (or, with ``parent`` None, PATCH the execution
        ``name`` with new parameters) and poll it to ``finished``;
        (seconds, GET body, launches). The job's own seconds (queue wait
        + run, from its execution document) go to ``job_seconds``."""
        _reset_launches(attn)
        t0 = time.monotonic()
        if parent is None:
            status, out = _http(base, "PATCH", f"/{verb}/tensorflow/{name}",
                                {"methodParameters": params})
            if status != 200:
                raise AssertionError(f"PATCH {name}: {status} {out}")
        else:
            post(f"/{verb}/tensorflow", {"name": name, "modelName": parent,
                                         "method": method,
                                         "methodParameters": params})
        _poll(base, f"/{verb}/tensorflow/{name}")
        wall = time.monotonic() - t0
        ran = _launches(attn)
        record_job(name)
        status, body = _http(base, "GET", f"/{verb}/tensorflow/{name}")
        return wall, body, ran

    def record_job(name):
        # the job marks the collection finished, then appends its
        # execution document
        for _ in range(400):
            done = ctx.catalog.get_documents(name)[-1]
            if "queueWaitSeconds" in done:
                break
            time.sleep(0.025)
        job_seconds[name] = done["queueWaitSeconds"] + done["elapsedSeconds"]

    def result(body):
        return next(d["result"] for d in body["result"] if "result" in d)

    phase_t0 = time.monotonic()
    try:
        t0 = time.monotonic()
        post("/dataset/csv", {"datasetName": "corpus",
                              "datasetURI": csv_path})
        meta = _poll(base, "/dataset/csv/corpus")
        ingest_s = time.monotonic() - t0
        record_job("corpus")
        if meta["rows"] != TRAIN_WINDOWS or len(meta["fields"]) != TRAIN_SEQ:
            raise AssertionError(f"ingested metadata {meta}")
        status, page = _http(base, "GET",
                             "/dataset/csv/corpus?skip=0&limit=2")
        head, first = page["result"]
        if status != 200 or head["_id"] != 0 or first["_id"] != 1 or \
                [first[f"t{i}"] for i in range(TRAIN_SEQ)] != x[0].tolist():
            raise AssertionError("the first page is not the metadata "
                                 "document and the first window")
        t0 = time.monotonic()
        table = ctx.params.resolve_value("$corpus")
        feed = dataframe_to_arrays(table)["x"]
        host = {"tableReadAndFeedSeconds": time.monotonic() - t0}
        if not isinstance(table, Table) or not np.array_equal(feed, x):
            raise AssertionError("$corpus does not give the windows")

        t0 = time.monotonic()
        post("/model/tensorflow", {
            "modelName": "lm", "modulePath": "learningorchestra_tpu.models",
            "class": "LanguageModel", "classParameters": LM_CONFIG})
        _poll(base, "/model/tensorflow/lm")
        create_s = time.monotonic() - t0
        record_job("lm")

        # the tutorial's body: checkpointed after each epoch
        fit_params = {"x": "$corpus", "batch_size": TRAIN_BATCH,
                      "epochs": TRAIN_EPOCHS, "grad_accum": TRAIN_ACCUM,
                      "checkpoint": True}
        fit_s, body, launches["pipelineFit"] = job(
            "train", "lm_t", "lm", "fit", fit_params)
        records = [d["epochRecord"] for d in body["result"]
                   if "epochRecord" in d]
        losses = [r["loss"] for r in records]
        if not body["metadata"]["finished"] or len(records) != TRAIN_EPOCHS:
            raise AssertionError(f"fit documents {body['result']}")
        if losses != yard["losses"]:
            raise AssertionError(f"REST fit losses {losses} differ from the "
                                 f"train phase's {yard['losses']}")
        need = LM_CONFIG["n_layers"] * steps * TRAIN_ACCUM
        want = dict.fromkeys(COUNTERS, 0)
        want.update(flash_fwd_sm90=need, flash_bwd_dq_sm90=need,
                    flash_bwd_dkv_sm90=need)
        if launches["pipelineFit"] != want:
            raise AssertionError(f"REST fit launched "
                                 f"{launches['pipelineFit']}, want {want}")
        epoch_s = [r["epochSeconds"] for r in records]

        eval_s, body, launches["pipelineEvaluate"] = job(
            "evaluate", "lm_ev", "lm_t", "evaluate",
            {"x": "$corpus", "batch_size": TRAIN_BATCH})
        evaluated = result(body)
        direct = yard["lm"].evaluate(x, batch_size=TRAIN_BATCH)
        if set(evaluated) != set(direct) or not all(
                abs(evaluated[k] - direct[k]) <= 1e-6 * abs(direct[k])
                for k in direct):
            raise AssertionError(f"REST evaluate {evaluated} differs from "
                                 f"the trained model's {direct}")

        prompt = [int(t) for t in x[1, :PROMPT_LENS[0]]]
        gen_s, body, launches["pipelineGenerate"] = job(
            "predict", "lm_gen", "lm_t", "generate",
            {"prompt": [prompt], "max_new_tokens": NEW_TOKENS})
        tokens = result(body)[0][len(prompt):]
        t0 = time.monotonic()
        trained = ctx.artifacts.load("lm_t")
        host["trainedArtifactLoadSeconds"] = time.monotonic() - t0
        solo = trained.generate(
            [prompt], max_new_tokens=NEW_TOKENS)[0][len(prompt):].tolist()
        if tokens != solo or len(tokens) != NEW_TOKENS:
            raise AssertionError(f"REST generate {tokens} differs from the "
                                 f"reloaded artifact's {solo}")
        ran = launches["pipelineGenerate"]
        if ran["flash_fwd_tf32x3"] < LM_CONFIG["n_layers"] or any(
                n for k, n in ran.items() if k != "flash_fwd_tf32x3"):
            raise AssertionError(f"the generate prefill launched {ran}")

        post("/serve/lm_t", {"type": "lm", "maxSlots": 2,
                             "cacheLen": TRAIN_SEQ, "temperature": 0.0})
        served = post("/serve/lm_t/predict",
                      {"prompt": prompt, "maxNewTokens": NEW_TOKENS}, 200)
        _http(base, "DELETE", "/serve/lm_t")
        if served["tokens"] != tokens:
            raise AssertionError(f"served tokens {served['tokens']} differ "
                                 f"from the REST generate's {tokens}")

        checkpoints = _checkpoint_checks(ctx, "lm_t", steps)
        resume = _resume_checks(ctx, job, base, fit_params, losses, trained,
                                x, steps, launches)
        lora = _lora_checks(torch, ctx, job, post, base, home, trained,
                            launches)

        refused = post("/predict/tensorflow", {
            "name": "lm_timeout", "modelName": "lm_t", "method": "generate",
            "methodParameters": {"prompt": [[1, 2]]}, "timeout": 60}, 406)
        if _http(base, "GET", "/predict/tensorflow/lm_timeout")[0] != 404:
            raise AssertionError("a refused request left a collection")
        post("/train/tensorflow", {"name": "lm_bad", "modelName": "lm",
                                   "method": "fit",
                                   "methodParameters": {"x": "$ghost"}})
        ctx.jobs.wait("lm_bad", timeout=600)
        status, bad = _http(base, "GET", "/train/tensorflow/lm_bad")
        if bad["metadata"]["finished"] or not bad["result"][-1].get(
                "exception"):
            raise AssertionError(f"the failed fit was not recorded: {bad}")
    finally:
        server.stop()
    per_step = {k: n / steps for k, n in launches["pipelineFit"].items() if n}
    log.append("pipeline " + json.dumps({
        "phaseSeconds": time.monotonic() - phase_t0, "pollSeconds": 0.25,
        "ingestSeconds": ingest_s, "ingestRows": TRAIN_WINDOWS,
        "ingestColumns": TRAIN_SEQ, "modelCreateSeconds": create_s,
        "fitWallSeconds": fit_s, "fitEpochSeconds": epoch_s,
        "jobSeconds": job_seconds,
        "jobPlaneOverheadSeconds": job_seconds["lm_t"] - sum(epoch_s),
        "hostSeconds": host,
        "losses": losses, "lossesEqualTrainPhase": True,
        "stepMsEpoch2": epoch_s[1] / (steps // TRAIN_EPOCHS) * 1e3,
        "trainTokensPerSecEpoch2": TRAIN_WINDOWS * TRAIN_SEQ / epoch_s[1],
        "launchesPerStep": per_step,
        "evaluateSeconds": eval_s, "evaluate": evaluated,
        "evaluateDirect": direct,
        "generateSeconds": gen_s, "generatePrompt": len(prompt),
        "generateTokensEqualSolo": True, "servedTokensEqual": True,
        "launches": launches, "checkpoints": checkpoints,
        "resume": resume, "lora": lora, "refusedTimeout": refused["result"],
        "failedJobException": bad["result"][-1]["exception"]}))
    shutil.rmtree(ctx.config.checkpoints_dir, ignore_errors=True)
    return launches


def _checkpoint_checks(ctx, name: str, steps: int) -> dict:
    """The checkpointed REST fit of ``name`` committed a verified step
    dir after each epoch; its commit seconds and bytes."""
    from learningorchestra_tpu_torch.runtime.checkpoint import Checkpointer

    ck_dir = os.path.join(ctx.config.checkpoints_dir, name)
    saved = sorted(int(n) for n in os.listdir(ck_dir) if n.isdigit())
    want = [steps // TRAIN_EPOCHS * (e + 1) for e in range(TRAIN_EPOCHS)]
    ck = Checkpointer(ck_dir)
    if saved != want or ck.latest_step() != steps:
        raise AssertionError(f"{name} committed steps {saved}, want {want}")
    t0 = time.monotonic()
    for step in saved:
        ck.saved_metadata(step)  # re-hashed: raises when corrupt
    verify_s = time.monotonic() - t0
    meta = ctx.catalog.get_metadata(name)
    commits = meta["checkpointCommits"]
    if [c["step"] for c in commits] != want:
        raise AssertionError(f"{name} commits {commits}")
    return {"steps": saved, "checkpointSaveSeconds": [
        c["seconds"] for c in commits], "bytesPerStep": [
        c["bytes"] for c in commits], "verifySecondsAllSteps": verify_s,
        "checkpointCommitSeconds": meta["checkpointCommitSeconds"]}


def _resume_checks(ctx, job, base, fit_params, losses, trained, x,
                   steps: int, launches: dict) -> dict:
    """A fit of 1 epoch, then PATCHed to 2, resumes from its step and
    trains the second epoch exactly as the uninterrupted fit did; again
    after the newest step's payload is bit-flipped (it goes to the
    quarantine and the run restores the step before it). DELETE takes
    the checkpoint dir away."""
    import torch

    ck_dir = os.path.join(ctx.config.checkpoints_dir, "lm_rs")
    per_epoch = steps // TRAIN_EPOCHS
    need = dict.fromkeys(COUNTERS, 0)
    need.update(dict.fromkeys(
        ("flash_fwd_sm90", "flash_bwd_dq_sm90", "flash_bwd_dkv_sm90"),
        LM_CONFIG["n_layers"] * per_epoch * TRAIN_ACCUM))
    out = {}
    _, _, ran = job("train", "lm_rs", "lm", "fit",
                    dict(fit_params, epochs=1))
    first = [d["epochRecord"]["loss"] for d in ctx.catalog.get_documents(
        "lm_rs") if "epochRecord" in d]
    if first != losses[:1] or ran != need:
        raise AssertionError(f"lm_rs epoch 1: {first} {ran}")
    for case in ("pipelineResume", "pipelineResumeQuarantined"):
        if case == "pipelineResumeQuarantined":
            # one byte of the newest step's payload flipped, same size
            payload = os.path.join(ck_dir, str(steps), "checkpoint.msgpack")
            with open(payload, "r+b") as f:
                f.seek(os.path.getsize(payload) // 2)
                byte = f.read(1)
                f.seek(-1, os.SEEK_CUR)
                f.write(bytes([byte[0] ^ 0xFF]))
        n_docs = len(ctx.catalog.get_documents("lm_rs"))
        wall, _, launches[case] = job("train", "lm_rs", None, "fit",
                                      dict(fit_params, epochs=2))
        records = [d["epochRecord"] for d in
                   ctx.catalog.get_documents("lm_rs")[n_docs:]
                   if "epochRecord" in d]
        got = [r["loss"] for r in records]
        if got != losses[1:] or [r["epoch"] for r in records] != [1]:
            raise AssertionError(f"{case}: resumed epochs {records}, want "
                                 f"the uninterrupted fit's {losses[1:]}")
        if launches[case] != need:
            raise AssertionError(f"{case} launched {launches[case]}, want "
                                 f"{need}")
        meta = ctx.catalog.get_metadata("lm_rs")
        out[case] = {"wallSeconds": wall, "losses": got,
                     "epochSeconds": records[0]["epochSeconds"],
                     "stepMs": records[0]["epochSeconds"] / per_epoch * 1e3,
                     "checkpointRestores": meta["checkpointRestores"],
                     "checkpointSaveSeconds": [
                         c["seconds"] for c in meta["checkpointCommits"]]}
        if case == "pipelineResume":
            resumed = ctx.artifacts.load("lm_rs")
            same = all(torch.equal(resumed.params[k], trained.params[k])
                       for k in trained.params)
            ev_r = resumed.evaluate(x, batch_size=TRAIN_BATCH)
            ev_t = trained.evaluate(x, batch_size=TRAIN_BATCH)
            if not same or ev_r != ev_t:
                raise AssertionError(f"the resumed artifact differs from the "
                                     f"uninterrupted one: params equal "
                                     f"{same}, evaluate {ev_r} vs {ev_t}")
            out[case].update(paramsEqual=same, evaluate=ev_r)
            del resumed
        else:
            quarantined = os.listdir(os.path.join(ck_dir, ".quarantine"))
            restored = [r["step"] for r in meta["checkpointRestores"]]
            if not any(q.startswith(f"{steps}-") for q in quarantined) or \
                    restored != [per_epoch]:
                raise AssertionError(f"quarantine {quarantined}, restored "
                                     f"{restored}")
            out[case]["quarantine"] = quarantined
    status, _ = _http(base, "DELETE", "/train/tensorflow/lm_rs")
    if status != 200 or os.path.exists(ck_dir):
        raise AssertionError("DELETE left the checkpoint dir of lm_rs")
    out["deleteRemovedCheckpointDir"] = True
    return out


def _lora_checks(torch, ctx, job, post, base, home, trained,
                 launches) -> dict:
    """The tutorial's LoRA workflow over REST: ingest a second corpus,
    enable_lora, fit the adapters alone, merge_lora, then the tutorial's
    sampled generate on the merged model."""
    import numpy as np

    dx = _domain_windows(np, TRAIN_WINDOWS, TRAIN_SEQ, seed=1)
    csv_path = os.path.join(home, "domain.csv")
    with open(csv_path, "w") as f:
        f.write(",".join(f"t{i}" for i in range(dx.shape[1])) + "\n")
        for row in dx:
            f.write(",".join(map(str, row.tolist())) + "\n")
    post("/dataset/csv", {"datasetName": "domain_corpus",
                          "datasetURI": csv_path})
    _poll(base, "/dataset/csv/domain_corpus")
    out = {}
    out["enableSeconds"], _, launches["loraEnable"] = job(
        "train", "lm_lora", "lm_t", "enable_lora", {"rank": LORA_RANK})
    out["fitWallSeconds"], body, launches["loraFit"] = job(
        "train", "lm_ft", "lm_lora", "fit", {
            "x": "$domain_corpus", "epochs": LORA_EPOCHS,
            "batch_size": LORA_BATCH})
    records = [d["epochRecord"] for d in body["result"]
               if "epochRecord" in d]
    losses = [r["loss"] for r in records]
    steps = LORA_EPOCHS * TRAIN_WINDOWS // LORA_BATCH
    if len(losses) != LORA_EPOCHS or not losses[-1] < losses[0]:
        raise AssertionError(f"the fine-tune's loss did not fall: {losses}")
    want = dict.fromkeys(COUNTERS, 0)
    want.update(dict.fromkeys(
        ("flash_fwd_sm90", "flash_bwd_dq_sm90", "flash_bwd_dkv_sm90"),
        LM_CONFIG["n_layers"] * steps))
    if launches["loraFit"] != want:
        raise AssertionError(f"the fine-tune launched {launches['loraFit']}"
                             f", want {want}")
    out["mergeSeconds"], _, launches["loraMerge"] = job(
        "train", "lm_merged", "lm_ft", "merge_lora", {})
    lora = ctx.artifacts.load("lm_lora")
    tuned = ctx.artifacts.load("lm_ft")
    base_equal = all(torch.equal(tuned.params[k], trained.params[k])
                     for k in trained.params)
    adapters = [k for k in tuned.params if ".lora_" in k]
    moved = all(not torch.equal(tuned.params[k], lora.params[k])
                for k in adapters)
    if not base_equal or len(adapters) != 8 * LM_CONFIG["n_layers"] or \
            not moved:
        raise AssertionError(f"base weights equal {base_equal}, adapters "
                             f"{len(adapters)}, all moved {moved}")
    del lora
    merged = ctx.artifacts.load("lm_merged")
    if any(".lora_" in k for k in merged.params):
        raise AssertionError("merge_lora left adapters")
    evals = {}
    for dtype in ("float32", "bfloat16"):
        os.environ["LO_COMPUTE_DTYPE"] = dtype
        for name, model in (("adapted", tuned), ("merged", merged)):
            model._engine = None
            evals[f"{name}{dtype.capitalize()}"] = model.evaluate(
                dx, batch_size=8)
    os.environ["LO_COMPUTE_DTYPE"] = "bfloat16"
    rel = abs(evals["mergedFloat32"]["loss"] - evals["adaptedFloat32"][
        "loss"]) / abs(evals["adaptedFloat32"]["loss"])
    if not rel <= 1e-5:
        raise AssertionError(f"merged vs adapted float32 evaluate: relative "
                             f"{rel} ({evals})")
    out["generateSeconds"], body, launches["loraGenerate"] = job(
        "predict", "lm_gen2", "lm_merged", "generate", TUTORIAL_GENERATE)
    tokens = next(d["result"] for d in body["result"] if "result" in d)
    solo = merged.generate(**TUTORIAL_GENERATE).tolist()
    if tokens != solo:
        raise AssertionError(f"sampled REST generate {tokens} differs from "
                             f"the reloaded merged model's {solo}")
    step_ms = records[-1]["epochSeconds"] / (steps // LORA_EPOCHS) * 1e3
    out.update(losses=losses, epochSeconds=[r["epochSeconds"]
                                            for r in records],
               stepMsEpoch2=step_ms, baseEqual=True, adaptersMoved=True,
               evaluate=evals, mergedVsAdaptedRelFloat32=rel,
               generateTokensEqualSolo=True, generateTokens=len(solo[0]))
    return out


# the LM options phase: the tutorial LM with Mixtral-8x7B's router (8
# experts, 2 a token) over the JAX package's ungated GELU experts
MOE_CONFIG = dict(LM_CONFIG, n_experts=8, moe_k=2)
BEAM_PROMPT, BEAMS = 1024, 4
REMAT_DROPOUT = 0.1


def _moe_rest_fit(torch, base, ctx, x, post) -> dict:
    """(a) The MoE LM created and fitted over REST; the job's launches,
    losses and epoch seconds."""
    from learningorchestra_tpu_torch.ops import attention as attn

    ctx.artifacts.save({"tokens": x}, "corpus", "function/python")
    post("/model/tensorflow", {
        "modelName": "moe", "modulePath": "learningorchestra_tpu.models",
        "class": "LanguageModel", "classParameters": MOE_CONFIG})
    _poll(base, "/model/tensorflow/moe")
    _reset_launches(attn)
    t0 = time.monotonic()
    post("/train/tensorflow", {
        "name": "moe_t", "modelName": "moe", "method": "fit",
        "methodParameters": {"x": "$corpus.tokens",
                             "batch_size": TRAIN_BATCH,
                             "epochs": TRAIN_EPOCHS,
                             "grad_accum": TRAIN_ACCUM}})
    _poll(base, "/train/tensorflow/moe_t")
    wall = time.monotonic() - t0
    launches = _launches(attn)
    records = [d["epochRecord"] for d in ctx.catalog.get_documents("moe_t")
               if "epochRecord" in d]
    return {"launches": launches, "wallSeconds": wall,
            "losses": [r["loss"] for r in records],
            "epochSeconds": [r["epochSeconds"] for r in records]}


def _moe_checks(torch, lm, x) -> dict:
    """(a) The trained MoE LM's load-balance term and dropped copies per
    layer on one micro-batch of the fit's shape (bf16), and one optimizer
    step run twice from one state: the params must come out bit for
    bit the same."""
    eng = lm._get_engine()
    params = lm._master_params()
    micro = torch.from_numpy(x[:TRAIN_BATCH // TRAIN_ACCUM]).to(
        lm.device).long()
    blocks = [getattr(lm.module, f"layer_{i}").moe
              for i in range(MOE_CONFIG["n_layers"])]
    for moe in blocks:
        moe.stats = {}
    with torch.inference_mode():
        _, aux = torch.func.functional_call(
            lm.module, eng._cast(params), (micro,), {"return_aux": True})
    dropped = [moe.stats["dropped"] / moe.stats["copies"] for moe in blocks]
    for moe in blocks:
        moe.stats = None
    aux = float(aux)
    if not aux > 0:
        raise AssertionError(f"MoE load-balance term {aux}")
    saved = {k: p.detach().clone() for k, p in params.items()}
    batch = eng._to_device(next(iter(lm._batcher(
        x[:TRAIN_BATCH], TRAIN_BATCH).epoch(0))), lm.device)
    after = []
    for _ in range(2):
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(saved[k])
        eng._train_step_body(eng.init_state(params), batch, 0)
        after.append({k: p.detach().clone() for k, p in params.items()})
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(saved[k])
    apart = [k for k in params
             if not torch.equal(after[0][k], after[1][k])]
    if apart:
        raise AssertionError(f"a repeated MoE step moved {len(apart)} "
                             f"tensors differently: {apart[:4]}")
    del saved, after
    return {"auxSum": aux, "droppedCopyShareByLayer": dropped,
            "repeatStepBitIdentical": True}


def _remat_checks(torch, state, x) -> tuple:
    """(c) 2 bf16 steps of the dense tutorial fit with dropout under each
    remat policy from one state, then one float32 micro-step's gradients
    under each against no remat. Returns (report, launches by path)."""
    from learningorchestra_tpu_torch.models.transformer import \
        LanguageModel
    from learningorchestra_tpu_torch.ops import attention as attn

    config = dict(LM_CONFIG, dropout=REMAT_DROPOUT)
    need = LM_CONFIG["n_layers"] * TRAIN_ACCUM * 2
    report, paths, grads = {}, {}, {}
    for policy in ("none", "dots", "full"):
        lm = LanguageModel(**config, remat=policy, device="cuda")
        lm.set_params(state)
        lm._set_grad_accum(TRAIN_ACCUM)
        eng = lm._get_engine()
        tstate = eng.init_state(lm._master_params())
        batches = [eng._to_device(b, lm.device) for b in
                   lm._batcher(x[:2 * TRAIN_BATCH], TRAIN_BATCH).epoch(0)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches(attn)
        step_ms, losses = [], []
        for batch in batches:
            t0 = time.monotonic()
            s, c = eng._train_step_body(tstate, batch, 0)["loss"]
            torch.cuda.synchronize()
            step_ms.append((time.monotonic() - t0) * 1e3)
            losses.append(float(s) / float(c))
        ran = _launches(attn)
        fwd = need * (1 if policy == "none" else 2)
        want = dict.fromkeys(COUNTERS, 0)
        want.update(flash_fwd_sm90=fwd, flash_bwd_dq_sm90=need,
                    flash_bwd_dkv_sm90=need)
        if ran != want:
            raise AssertionError(f"remat {policy}: launches {ran}, want "
                                 f"{want} (the recompute relaunches the "
                                 f"forward)")
        report[policy] = {"stepMs": step_ms, "losses": losses,
                          "maxMemoryAllocatedBytes":
                              torch.cuda.max_memory_allocated()}
        paths[f"lmOptionsRemat{policy.capitalize()}"] = ran
        del lm, eng, tstate, batches
        # one float32 micro-step of 2 windows, dropout on
        os.environ["LO_COMPUTE_DTYPE"] = "float32"
        try:
            lm = LanguageModel(**config, remat=policy, device="cuda")
            lm.set_params(state)
            eng = lm._get_engine()
            g, _ = eng._micro_grads(lm._master_params(), eng._to_device(
                {"x": x[:2]}, lm.device), 0)
            grads[policy] = g
            del lm, eng
        finally:
            os.environ["LO_COMPUTE_DTYPE"] = "bfloat16"
    first = {p: r["losses"][0] for p, r in report.items()}
    if len(set(first.values())) != 1:
        raise AssertionError(f"the first step's loss differs by remat "
                             f"policy: {first}")
    peaks = [report[p]["maxMemoryAllocatedBytes"]
             for p in ("none", "dots", "full")]
    if not peaks[0] > peaks[1] > peaks[2]:
        raise AssertionError(f"peak memory none/dots/full {peaks} does not "
                             f"fall")
    for policy in ("dots", "full"):
        rel = {k: ((grads[policy][k] - grads["none"][k]).norm()
                   / grads["none"][k].norm().clamp_min(1e-30)).item()
               for k in grads["none"]}
        worst = max(rel, key=rel.get)
        if not rel[worst] <= 1e-4:
            raise AssertionError(f"remat {policy} float32 gradient of "
                                 f"{worst}: relative L2 {rel[worst]}")
        report[policy]["f32GradRelL2VsNone"] = {"max": rel[worst],
                                                "worst": worst}
    return report, paths


def _fuse_tree(tree, qkv: bool):
    """The fused layout of a split flax tree: gate/up concatenated into
    ``gate_up`` and, with ``qkv``, q/k/v into ``qkv_proj``."""
    import numpy as np

    out = dict(tree)
    for name, layer in tree.items():
        if not name.startswith("layer_"):
            continue
        layer = dict(layer)
        if qkv:
            attn = dict(layer["attn"])
            attn["qkv_proj"] = {"kernel": np.concatenate(
                [attn.pop(p)["kernel"]
                 for p in ("q_proj", "k_proj", "v_proj")], axis=1)}
            layer["attn"] = attn
        mlp = dict(layer["mlp"])
        mlp["gate_up"] = {"kernel": np.concatenate(
            [mlp.pop("gate")["kernel"], mlp.pop("up_proj")["kernel"]],
            axis=1)}
        layer["mlp"] = mlp
        out[name] = layer
    return out


def _fused_checks(torch, x) -> tuple:
    """(d) The dense tutorial LM with fused projections (GQA: gate_up
    only) and its 8-kv-head variant (qkv_proj too), each built from its
    split tree's weights: float32 logits of a 1024-token window against
    the split model's, and one bf16 fit step."""
    import numpy as np

    from learningorchestra_tpu_torch.models import weights
    from learningorchestra_tpu_torch.models.transformer import \
        LanguageModel
    from learningorchestra_tpu_torch.ops import attention as attn

    report, paths = {}, {}
    window = torch.from_numpy(x[:1, :BEAM_PROMPT]).to("cuda").long()
    for name, config, qkv in (("gqa", LM_CONFIG, False),
                              ("mha", dict(LM_CONFIG, n_kv_heads=8), True)):
        tree = weights.init_params(config, seed=0)
        split = LanguageModel(**config, device="cuda")
        split.set_params(weights.params_from_flax(tree))
        fused = LanguageModel(**config, fused_proj=True, device="cuda")
        fused.set_params(weights.params_from_flax(_fuse_tree(tree, qkv)))
        keys = set(fused.params)
        if ("layer_0.attn.qkv_proj.weight" in keys) != qkv or \
                "layer_0.mlp.gate_up.weight" not in keys:
            raise AssertionError(f"fused {name} tree: {sorted(keys)[:8]}")
        with torch.inference_mode():
            got, want = fused.module(window), split.module(window)
        err = (got - want).abs().max().item()
        if not bool(torch.isfinite(got).all()) or not err <= 1e-4:
            raise AssertionError(f"fused {name} logits vs split: {err}")
        del split
        _reset_launches(attn)
        hist = fused.fit(x[:TRAIN_BATCH], batch_size=TRAIN_BATCH, epochs=1,
                         grad_accum=TRAIN_ACCUM, shuffle=False).history
        ran = _launches(attn)
        need = config["n_layers"] * TRAIN_ACCUM
        want_ran = dict.fromkeys(COUNTERS, 0)
        want_ran.update(flash_fwd_sm90=need, flash_bwd_dq_sm90=need,
                        flash_bwd_dkv_sm90=need)
        if ran != want_ran or not np.isfinite(hist["loss"][0]):
            raise AssertionError(f"fused {name} fit step: {ran} "
                                 f"{hist['loss']}")
        report[name] = {"logitsMaxAbsErrVsSplit": err,
                        "fitStepLoss": hist["loss"][0],
                        "fitStepSeconds": hist["epochSeconds"][0]}
        paths[f"lmOptionsFused{name.capitalize()}Fit"] = ran
        del fused
    return report, paths


def _seq_logprob(torch, lm, seq, prompt_len: int) -> float:
    """The model's summed log-prob of ``seq``'s continuation, token 0
    masked (float32), as beam search ranks it."""
    from learningorchestra_tpu_torch.models.transformer import NEG_INF

    tokens = torch.tensor([seq], device=lm.device)
    with torch.inference_mode():
        logits = lm.module(tokens)[0].float()
        logits[:, 0] = NEG_INF
        lp = torch.log_softmax(logits, dim=-1)
        pos = torch.arange(prompt_len, len(seq), device=lm.device)
        return float(lp[pos - 1, tokens[0, pos]].double().sum())


def _moe_serving(torch, base, ctx, lm, post) -> tuple:
    """(f) The trained MoE LM on a fresh slot and a fresh paged session,
    float32: the serving phase's 4 prompts sent one after another (each
    step's batch fixed by the order), then all 4 at once for the rates.
    (g) The lane overrun of a retired stream on a paged session."""
    import numpy as np

    from learningorchestra_tpu_torch.ops import attention as attn
    from learningorchestra_tpu_torch.services.serving import (
        PagedLMServingSession, _Request)

    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(1, LM_CONFIG["vocab_size"],
                                             size=n)]
               for n in PROMPT_LENS]
    solos = [[int(t) for t in lm.generate(
        [p], max_new_tokens=NEW_TOKENS)[0][len(p):]] for p in prompts]
    report, paths, tokens = {}, {}, {}
    for kind, extra in (("slot", {}),
                        ("paged", {"kv": "paged", "pageLen": PAGE_LEN})):
        post("/serve/moe_t", dict({"type": "lm", "maxSlots": 4,
                                   "cacheLen": 2048, "temperature": 0.0},
                                  **extra))
        _reset_launches(attn)
        out = [_http(base, "POST", "/serve/moe_t/predict",
                     {"prompt": p, "maxNewTokens": NEW_TOKENS})
               for p in prompts]
        ran = _launches(attn)
        tokens[kind] = _round_tokens(f"moe {kind}", out, NEW_TOKENS)
        want = dict.fromkeys(COUNTERS, 0)
        want["flash_fwd_tf32x3"] = LM_CONFIG["n_layers"] * len(prompts)
        if ran != want:
            raise AssertionError(f"MoE {kind} prefills launched {ran}, "
                                 f"want {want}")
        paths[f"lmOptionsMoe{kind.capitalize()}"] = ran
        out, walls, wall = _predict_round(base, "moe_t", prompts,
                                          NEW_TOKENS)
        _round_tokens(f"moe {kind} concurrent", out, NEW_TOKENS)
        report[kind] = {"concurrent": {
                            "wallSeconds": wall,
                            **_round_rates(out, walls, NEW_TOKENS)},
                        "sequentialVsSolo": _agreement(tokens[kind], solos)}
        status, _ = _http(base, "DELETE", "/serve/moe_t")
        if status != 200:
            raise AssertionError(f"delete MoE {kind} session: {status}")
    report["pagedVsSlot"] = _agreement(tokens["paged"], tokens["slot"])

    # (g) a long stream retires past its first page while only a short
    # one lives: the next steps gather one page, and the retired lane's
    # column (kept, as the JAX session keeps it) lies past that slice
    sess = PagedLMServingSession(
        "lane", ctx, lm, slots=4, cache_len=2048, temperature=0.0,
        top_k=None, top_p=None, page_len=PAGE_LEN,
        n_pages=4 * 2048 // PAGE_LEN + 1)
    long_req = _Request({"prompt": prompts[0][:PAGE_LEN + 4],
                         "maxNewTokens": 3})
    short_req = _Request({"prompt": prompts[1][:3], "maxNewTokens": 8})
    sess._queue.extend([long_req, short_req])
    overruns = 0
    while sess._queue or sess._active_slots():
        if sess._active_slots() == [1]:
            overruns += int(sess._col[0]) // PAGE_LEN >= sess._gather_width()
        sess._serve_once()
    torch.cuda.synchronize()
    if not overruns or long_req.error or short_req.error or \
            [len(r.result["tokens"]) for r in (long_req, short_req)] != [3, 8]:
        raise AssertionError(f"lane overrun: {overruns} overrunning steps, "
                             f"errors {long_req.error} {short_req.error}")
    report["laneOverrun"] = {"overrunSteps": overruns, "error": None}
    return report, paths


def lm_options_phase(torch, log, home, yard):
    """The LanguageModel's options on the card (the ``lmOptions`` line).
    (a) The MoE tutorial LM (8 experts, k 2) created and fitted over REST
    in bf16 on the train phase's windows: the loss falls, the
    load-balance term is positive, 8 layers x 16 micro-batches of each
    wgmma kernel and nothing else, and one step repeated from one state
    gives the same bits; step time, idle share over 2 profiled steps,
    dropped copies per layer, peak memory. (b) Its float32 gradient
    micro-step through the split-TF32 kernels against the dense path
    (1e-4 relative L2 per tensor). (c) Remat none/dots/full under dropout
    0.1 on the dense LM: equal first-step losses, falling peak memory,
    the forward launched twice under remat, float32 gradients within
    1e-4 of no remat. (d) Fused projections, GQA and 8 kv heads, against
    their split trees. (e) Beam search (1 and 4 beams, 32 tokens after
    1024) over REST on the trained MoE LM: 1 beam equals greedy, 4 beams
    score at least greedy's log-prob. (f, g) MoE serving on the slot and
    paged sessions, and the paged lane overrun. Returns the launches of
    each path."""
    import numpy as np

    from learningorchestra_tpu_torch.config import Config
    from learningorchestra_tpu_torch.models import weights
    from learningorchestra_tpu_torch.ops import attention as attn
    from learningorchestra_tpu_torch.services.context import ServiceContext
    from learningorchestra_tpu_torch.services.server import RestServer

    os.environ["LO_COMPUTE_DTYPE"] = "bfloat16"
    x = yard["x"]
    phase_t0 = time.monotonic()
    ctx = ServiceContext(Config(home=os.path.join(home, "lo")),
                         device="cuda")
    server = RestServer(port=0, context=ctx).start()
    base = server.base_url
    paths, report = {}, {"config": MOE_CONFIG}

    def post(path, body, want=201):
        status, out = _http(base, "POST", path, body)
        if status != want:
            raise AssertionError(f"POST {path}: {status} {out}")
        return out

    try:
        # (a) the MoE fit over REST
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fit = _moe_rest_fit(torch, base, ctx, x, post)
        peak = torch.cuda.max_memory_allocated()
        losses = fit["losses"]
        steps = TRAIN_EPOCHS * TRAIN_WINDOWS // TRAIN_BATCH
        need = LM_CONFIG["n_layers"] * steps * TRAIN_ACCUM
        want = dict.fromkeys(COUNTERS, 0)
        want.update(flash_fwd_sm90=need, flash_bwd_dq_sm90=need,
                    flash_bwd_dkv_sm90=need)
        if fit["launches"] != want:
            raise AssertionError(f"MoE fit launched {fit['launches']}, "
                                 f"want {want}")
        if len(losses) != TRAIN_EPOCHS or not all(np.isfinite(losses)) or \
                not losses[1] < losses[0]:
            raise AssertionError(f"MoE fit losses {losses}")
        paths["lmOptionsMoeFit"] = fit["launches"]
        trained = ctx.artifacts.load("moe_t")
        trained._set_grad_accum(TRAIN_ACCUM)
        epoch2 = fit["epochSeconds"][1]
        report["moeFit"] = {
            "windows": TRAIN_WINDOWS, "seq": TRAIN_SEQ,
            "batch": TRAIN_BATCH, "gradAccum": TRAIN_ACCUM,
            "epochs": TRAIN_EPOCHS, "computeDtype": "bfloat16",
            "losses": losses, "epochSeconds": fit["epochSeconds"],
            "jobWallSeconds": fit["wallSeconds"],
            "stepMs": epoch2 / (steps // TRAIN_EPOCHS) * 1e3,
            "trainTokensPerSec": TRAIN_WINDOWS * TRAIN_SEQ / epoch2,
            "maxMemoryAllocatedBytes": peak,
            **_moe_checks(torch, trained, x),
            "profile": _profiled_window(torch, trained, x)}

        # (b) the float32 gradient micro-step, kernels against dense
        init = weights.params_from_flax(weights.init_params(MOE_CONFIG,
                                                            seed=0))
        grad = _grads_vs_dot(torch, "lmOptionsMoeFloat32Grad", MOE_CONFIG,
                             init, "float32", 1e-4, x[:2])
        paths["lmOptionsMoeFloat32Grad"] = grad["launches"]
        report["moeFloat32GradRelL2VsDot"] = grad["relL2VsDot"]
        del init

        # (c) remat, (d) fused projections
        state = weights.params_from_flax(weights.init_params(LM_CONFIG,
                                                             seed=0))
        report["remat"], ran = _remat_checks(torch, state, x)
        paths.update(ran)
        del state
        report["fused"], ran = _fused_checks(torch, x)
        paths.update(ran)

        # (e) beam search over REST on the trained MoE LM, float32
        prompt = [int(t) for t in x[2, :BEAM_PROMPT]]
        beams = {}
        for n in (1, BEAMS):
            _reset_launches(attn)
            post("/predict/tensorflow", {
                "name": f"moe_beam{n}", "modelName": "moe_t",
                "method": "generate", "methodParameters": {
                    "prompt": [prompt], "max_new_tokens": NEW_TOKENS,
                    "num_beams": n}})
            _poll(base, f"/predict/tensorflow/moe_beam{n}")
            ran = _launches(attn)
            want = dict.fromkeys(COUNTERS, 0)
            want["flash_fwd_tf32x3"] = LM_CONFIG["n_layers"]
            if ran != want:
                raise AssertionError(f"beam {n} launched {ran}, want {want}")
            paths[f"lmOptionsBeam{n}"] = ran
            seq = next(d["result"] for d in ctx.catalog.get_documents(
                f"moe_beam{n}") if "result" in d)[0]
            torch.cuda.synchronize()
            t0 = time.monotonic()
            trained.generate([prompt], max_new_tokens=NEW_TOKENS,
                             num_beams=n)
            torch.cuda.synchronize()
            beams[n] = {"tokens": seq[len(prompt):],
                        "logProb": _seq_logprob(torch, trained, seq,
                                                len(prompt)),
                        "msPerToken": (time.monotonic() - t0) * 1e3
                        / NEW_TOKENS}
        greedy = [int(t) for t in trained.generate(
            [prompt], max_new_tokens=NEW_TOKENS)[0][len(prompt):]]
        if beams[1]["tokens"] != greedy:
            raise AssertionError("1 beam differs from greedy generate")
        # the two sums come from one float32 forward each; beam search
        # ranked them on its decode steps' logits
        if not beams[BEAMS]["logProb"] >= beams[1]["logProb"] - 1e-4 * abs(
                beams[1]["logProb"]):
            raise AssertionError(f"{BEAMS} beams scored "
                                 f"{beams[BEAMS]['logProb']}, below greedy's "
                                 f"{beams[1]['logProb']}")
        report["beam"] = {
            "prompt": BEAM_PROMPT, "newTokens": NEW_TOKENS,
            "beam1EqualsGreedy": True,
            **{f"beams{n}": {k: v for k, v in b.items() if k != "tokens"}
               for n, b in beams.items()},
            "beamTokensEqualGreedy": beams[BEAMS]["tokens"] == greedy}

        # (f) MoE serving, (g) the lane overrun
        served, ran = _moe_serving(torch, base, ctx, trained, post)
        report["serving"] = served
        paths.update(ran)
    finally:
        server.stop()
        os.environ["LO_COMPUTE_DTYPE"] = "bfloat16"
    report["phaseSeconds"] = time.monotonic() - phase_t0
    log.append("lmOptions " + json.dumps(report))
    return paths


def classifier_phase(torch, log, home, yard):
    """The tutorial's TextClassifier on the card in bf16 with
    ``attention="flash"``: a 3-epoch fit of 1024 rows of 512 tokens
    (the non-causal sm90 kernels at head_dim 32, 4 layers x 24 steps of
    each and nothing else), evaluate, predict (probability rows that sum
    to 1), the artifact's round trip, one float32 gradient micro-step
    through the split-TF32 kernels against the dense path, and ``POST
    /model`` of the tutorial's body. Returns the kernel launches of the
    fit and of the gradient step; leaves the classifier and its rows in
    ``yard`` for the serving plane's bucketed phase."""
    import numpy as np

    from learningorchestra_tpu_torch.config import Config
    from learningorchestra_tpu_torch.models.encoder import TextClassifier
    from learningorchestra_tpu_torch.ops import attention as attn
    from learningorchestra_tpu_torch.runtime.data import MASK_KEY
    from learningorchestra_tpu_torch.services.context import ServiceContext
    from learningorchestra_tpu_torch.services.server import RestServer

    os.environ["LO_COMPUTE_DTYPE"] = "bfloat16"
    x, y = _marker_rows(np, CLF_ROWS, CLF_SEQ, CLF_CONFIG["vocab_size"],
                        seed=0)
    clf = TextClassifier(**CLF_CONFIG, attention="flash", device="cuda")
    steps = CLF_EPOCHS * CLF_ROWS // CLF_BATCH
    _reset_launches(attn)
    t0 = time.monotonic()
    hist = clf.fit(x, y, batch_size=CLF_BATCH, epochs=CLF_EPOCHS).history
    fit_s = time.monotonic() - t0
    launches = _launches(attn)
    losses = hist["loss"]
    want = dict.fromkeys(COUNTERS, 0)
    want.update(dict.fromkeys(
        ("flash_fwd_sm90", "flash_bwd_dq_sm90", "flash_bwd_dkv_sm90"),
        CLF_CONFIG["n_layers"] * steps))
    if launches != want:
        raise AssertionError(f"the classifier's fit launched {launches}, "
                             f"want {want}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"the classifier's loss did not fall: {losses}")
    evaluated = clf.evaluate(x, y, batch_size=CLF_BATCH)
    probs = clf.predict(x, batch_size=CLF_BATCH)
    row_err = float(np.abs(probs.sum(axis=1) - 1.0).max())
    if probs.shape != (CLF_ROWS, 2) or not row_err <= 1e-5:
        raise AssertionError(f"predict rows: shape {probs.shape}, max |sum "
                             f"- 1| {row_err}")
    ctx = ServiceContext(Config(home=home), device="cuda")
    ctx.artifacts.save(clf, "clf_t", "train/tensorflow")
    loaded = ctx.artifacts.load("clf_t")
    if not np.array_equal(loaded.predict(x, batch_size=CLF_BATCH), probs):
        raise AssertionError("the reloaded classifier predicts otherwise")

    # float32: one micro-step of 8 rows through the split-TF32 kernels
    # (non-causal, head_dim 32) against the dense path
    os.environ["LO_COMPUTE_DTYPE"] = "float32"
    state = {k: t.detach().cpu() for k, t in clf.params.items()}
    grads, grad_launches = {}, {}
    for impl in ("flash", "dot"):
        model = TextClassifier(**CLF_CONFIG, attention=impl, device="cuda")
        model.set_params(state)
        eng = model._get_engine()
        batch = eng._to_device({"x": x[:8], "y": y[:8],
                                MASK_KEY: np.ones(8, np.float32)},
                               model.device)
        _reset_launches(attn)
        grads[impl], _ = eng._micro_grads(
            dict(model.module.named_parameters()), batch, 0)
        grad_launches[impl] = _launches(attn)
        del model, eng
    os.environ["LO_COMPUTE_DTYPE"] = "bfloat16"
    want_f32 = dict.fromkeys(COUNTERS, 0)
    want_f32.update(dict.fromkeys(
        ("flash_fwd_tf32x3", "flash_bwd_dq_tf32x3", "flash_bwd_dkv_tf32x3"),
        CLF_CONFIG["n_layers"]))
    if grad_launches != {"flash": want_f32,
                         "dot": dict.fromkeys(COUNTERS, 0)}:
        raise AssertionError(f"the float32 gradient step launched "
                             f"{grad_launches}")
    rel = {k: ((grads["flash"][k] - grads["dot"][k]).norm()
               / grads["dot"][k].norm().clamp_min(1e-30)).item()
           for k in grads["dot"]}
    worst = max(rel, key=rel.get)
    if not rel[worst] <= 1e-4:
        raise AssertionError(f"classifier float32 gradient of {worst}: "
                             f"relative L2 {rel[worst]} against dot")

    server = RestServer(port=0, context=ctx).start()
    try:
        body = {"modelName": "clf", "modulePath":
                "learningorchestra_tpu.models", "class": "TextClassifier",
                "classParameters": CLF_CONFIG}
        status, out = _http(server.base_url, "POST", "/model/tensorflow",
                            body)
        if status != 201:
            raise AssertionError(f"POST /model TextClassifier: {status} "
                                 f"{out}")
        _poll(server.base_url, "/model/tensorflow/clf")
    finally:
        server.stop()
        ctx.close()
    yard.update(clf=clf, clfRows=x)
    log.append("classifier " + json.dumps({
        "config": CLF_CONFIG, "attention": "flash", "rows": CLF_ROWS,
        "seq": CLF_SEQ, "batch": CLF_BATCH, "epochs": CLF_EPOCHS,
        "optimizerSteps": steps, "computeDtype": "bfloat16",
        "history": hist, "fitSeconds": fit_s, "launches": launches,
        "stepMsEpoch3": hist["epochSeconds"][-1] / (steps // CLF_EPOCHS)
        * 1e3,
        "tokensPerSecEpoch3": CLF_ROWS * CLF_SEQ / hist["epochSeconds"][-1],
        "evaluate": evaluated, "predictRowSumMaxErr": row_err,
        "artifactRoundTripEqual": True,
        "f32GradRelL2VsDot": {"max": rel[worst], "worst": worst},
        "f32GradLaunches": grad_launches["flash"],
        "restModelCreated": True}))
    return {"classifierFit": launches,
            "classifierFloat32Grad": grad_launches["flash"]}

# the serving plane's draft: a small LM with the tutorial LM's vocabulary
# and context (head_dim 64), fitted in the phase in bf16 on the train
# phase's windows
DRAFT_CONFIG = dict(vocab_size=32000, d_model=256, n_layers=2, n_heads=4,
                    n_kv_heads=2, d_ff=0, max_len=2048, sliding_window=1024,
                    rope_base=10000.0)
DRAFT_LR, DRAFT_BATCH, DRAFT_MAX_STEPS = 1e-3, 16, 8
SPEC_K = 4
# the prompt of random ids, off the successor pattern
OFF_PATTERN_PROMPT = 1200
# decode cadence under a burst: two in-flight streams of 64 tokens after
# 256-token prompts, and two 1500-token prompts arriving mid-stream
CADENCE_PROMPT, CADENCE_NEW, BURST_PROMPT = 256, 64, 1500
# rows a bucketed predict burst sends, one burst after another, then the
# rows of three concurrent clients
BUCKET_BURSTS, BUCKET_CLIENTS = ((1, 1), (3, 4), (5, 8)), (2, 3, 3)


def _distinct_windows(x, n: int, skip=()) -> list:
    """Indices of ``n`` windows of ``x`` with pairwise distinct first ids
    (and none of ``skip``'s): the successor stream repeats every 63 ids,
    so two windows share a prefix exactly when they start alike."""
    seen = {int(x[i, 0]) for i in skip}
    out = []
    for i in range(len(x)):
        if int(x[i, 0]) not in seen:
            seen.add(int(x[i, 0]))
            out.append(i)
        if len(out) == n:
            return out
    raise AssertionError(f"fewer than {n} distinct windows")


def _fit_draft(x, target_loss: float):
    """The draft LM from ``init_params(DRAFT_CONFIG, 0)``, fitted in bf16
    an epoch (4 steps of 16 windows) at a time until its epoch loss is
    below ``target_loss`` or it has taken DRAFT_MAX_STEPS steps. Returns
    the model, its epoch losses and the launches of its fit."""
    from learningorchestra_tpu_torch.models import weights
    from learningorchestra_tpu_torch.models.transformer import \
        LanguageModel
    from learningorchestra_tpu_torch.ops import attention as attn

    os.environ["LO_COMPUTE_DTYPE"] = "bfloat16"
    draft = LanguageModel(**DRAFT_CONFIG, device="cuda")
    draft.set_params(weights.params_from_flax(
        weights.init_params(DRAFT_CONFIG, seed=0)))
    draft.compile({"kind": "adamw", "learning_rate": DRAFT_LR})
    per_epoch = len(x) // DRAFT_BATCH
    losses = []
    _reset_launches(attn)
    while len(losses) * per_epoch < DRAFT_MAX_STEPS:
        hist = draft.fit(x, batch_size=DRAFT_BATCH, epochs=1,
                         grad_accum=1).history
        losses.append(hist["loss"][0])
        if losses[-1] < target_loss:
            break
    launches = _launches(attn)
    steps = len(losses) * per_epoch
    want = dict.fromkeys(COUNTERS, 0)
    want.update(dict.fromkeys(
        ("flash_fwd_sm90", "flash_bwd_dq_sm90", "flash_bwd_dkv_sm90"),
        DRAFT_CONFIG["n_layers"] * steps))
    if launches != want or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"the draft's fit launched {launches} (want "
                             f"{want}), losses {losses}")
    return draft, losses, steps, launches


def _spec_expectation(news, k: int) -> float:
    """Accepted drafts per verify step if every draft were accepted: a
    stream of ``n`` tokens takes its first from the prefill and the rest
    in ceil((n - 1) / (k + 1)) rounds, the last one clamped at its end."""
    rounds = [-(-(n - 1) // (k + 1)) for n in news]
    return sum(n - 1 - r for n, r in zip(news, rounds)) / sum(rounds)


def _timed_calls(torch, session, names) -> dict:
    """Wraps each of ``session``'s step functions named in ``names`` to
    record its milliseconds, the card synchronized at its end (the
    session reads each result to the host right after anyway). Returns
    the lists it fills, by name."""
    times = {}
    for name in names:
        inner = getattr(session, name)
        times[name] = []

        def timed(*args, _inner=inner, _into=times[name]):
            t = time.monotonic()
            out = _inner(*args)
            torch.cuda.synchronize()
            _into.append((time.monotonic() - t) * 1e3)
            return out

        setattr(session, name, timed)
    return times


# the report's key of each timed step function
_CALL_KEYS = {"_verify": "verifyMsP50", "_draft_propose": "proposeMsP50",
              "_pstep": "stepMsP50"}


def _prefix_held(session) -> int:
    """Page references the session's prefix cache holds itself: an idle
    pool has all its pages free but these."""
    with session.prefix._lock:
        return sum(len(e["held"]) for e in session.prefix._entries.values())


def _p50(values) -> float:
    values = sorted(values)
    return values[(len(values) - 1) // 2]


def _cadence(base, ctx, body, streams, burst, want) -> dict:
    """Two streams decode CADENCE_NEW tokens while two 1500-token prompts
    arrive, on a fresh session of ``body``. The decode rounds are timed
    on the session's own thread; returns the in-flight streams' largest
    and median gap between rounds that gave them a token."""
    session_name = "lm"
    _create(base, session_name, body)
    session = ctx.serving._sessions[session_name]
    times = {len(p): [] for p in streams}
    inner = session._decode_round

    def timed(active):
        lens = [len(session._slot_req[s].payload["prompt"]) for s in active]
        inner(active)
        now = time.monotonic()
        for n in lens:
            if n in times:
                times[n].append(now)

    session._decode_round = timed
    out = [None] * 4
    prompts = list(streams) + list(burst)
    news = [CADENCE_NEW] * len(streams) + [1] * len(burst)

    def client(i):
        out[i] = _http(base, "POST", f"/serve/{session_name}/predict",
                       {"prompt": prompts[i], "maxNewTokens": news[i]})

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(4)]
    for t in threads[:2]:
        t.start()
    deadline = time.monotonic() + 120
    while min(len(v) for v in times.values()) < 8:
        if time.monotonic() > deadline:
            raise AssertionError("cadence: the streams never decoded")
        time.sleep(0.002)
    burst_at = time.monotonic()
    for t in threads[2:]:
        t.start()
    for t in threads:
        t.join(timeout=600)
    _http(base, "DELETE", f"/serve/{session_name}")
    for i, result in enumerate(out):
        if result is None or result[0] != 200:
            raise AssertionError(f"cadence predict {i}: {result}")
        if result[1]["tokens"] != want[i]:
            raise AssertionError(f"cadence predict {i} differs from solo")
    gaps = sorted((b - a) * 1e3 for v in times.values()
                  for a, b in zip(v, v[1:]) if b > burst_at)
    return {"mode": "disagg" if body.get("disagg") else "fused",
            "roundsAfterBurst": len(gaps),
            "maxGapMs": gaps[-1], "p50GapMs": gaps[(len(gaps) - 1) // 2],
            "tokensEqualSolo": True}


def serving_plane_phase(torch, log, home, yard):
    """Speculative decoding, disaggregated prefill/decode and bucketed
    predict over REST on the card (the ``servingPlane`` line). The
    target is the train phase's LM, served in float32 (prefills on
    flash_fwd_tf32x3); the draft a 2-layer LM of width 256 fitted here in
    bf16 (the sm90 kernels). Prompts: 1100/1234/1367/1500 tokens of the
    successor windows, where the draft mostly agrees with the target,
    and 1200 random ids, where it mostly does not; 32 greedy tokens each
    on ``maxSlots`` 4, 16-token pages. (a) The target as its own draft,
    specK 4: every stream equals solo; acceptance recorded against its
    end-of-stream bound. (b) disagg + spec with the small draft: every
    stream equals solo, mode colocated, one handoff a request, an empty
    handoff queue, roles {prefill, decode, draft}, 8 flash_fwd_tf32x3
    launches a target prefill and 2 a draft prefill and none in any
    verify or propose step, the pool back to the prefix cache's holds
    after delete; TTFT, decode tokens/s against a plain paged session and
    the draft's ms a round recorded. (c) ``kv_page_handoff:1``: one 429,
    no page leaked, the retry 200; latched: three 429s, ``mode``
    fused-degraded, later requests equal solo, the pool drained. (d) Two
    streams decoding while two 1500-token prompts arrive, fused and
    disaggregated: the largest and median gap between their tokens,
    tokens equal solo. (e) int8 KV with the self-draft: every request
    200, agreement with the exact tokens recorded. (f) The classifier
    phase's TextClassifier as ``type: "predict"``: bursts of 1, 3 and 5
    rows in buckets 1, 4 and 8, then 3 concurrent clients; every row
    within 1e-5 of a direct ``predict`` of its padded bucket, 4 layers x
    predict calls of flash_fwd_sm90 and nothing else. Returns the launches
    of the draft's fit, of (b)'s measured round and of (f)."""
    import numpy as np

    from learningorchestra_tpu_torch.config import Config
    from learningorchestra_tpu_torch.ops import attention as attn
    from learningorchestra_tpu_torch.services import faults
    from learningorchestra_tpu_torch.services.context import ServiceContext
    from learningorchestra_tpu_torch.services.server import RestServer

    t0 = time.monotonic()
    x, target = yard["x"], yard["lm"]
    draft, draft_losses, draft_steps, fit_launches = _fit_draft(
        x, yard["losses"][1])
    report: dict = {
        "draftConfig": DRAFT_CONFIG, "specK": SPEC_K,
        "draftFit": {"steps": draft_steps, "losses": draft_losses,
                     "targetEpoch2Loss": yard["losses"][1],
                     "belowTarget": draft_losses[-1] < yard["losses"][1],
                     "learningRate": DRAFT_LR, "launches": fit_launches}}
    ctx = ServiceContext(Config(home=home), device="cuda")
    ctx.artifacts.save(target, "lm", "train/tensorflow")
    ctx.artifacts.save(draft, "draft", "train/tensorflow")
    rng = np.random.default_rng(3)
    measured = _distinct_windows(x, len(PROMPT_LENS))
    warm = _distinct_windows(x, len(PROMPT_LENS), skip=measured)
    prompts = [[int(t) for t in x[i, :n]]
               for i, n in zip(measured, PROMPT_LENS)]
    prompts.append([int(t) for t in rng.integers(
        1, LM_CONFIG["vocab_size"], size=OFF_PATTERN_PROMPT)])
    first_use = [[int(t) for t in x[i, 7:7 + n]]
                 for i, n in zip(warm, PROMPT_LENS)]

    def solo(p, new=NEW_TOKENS):
        return [int(t) for t in
                target.generate([p], max_new_tokens=new)[0][len(p):]]

    solos = [solo(p) for p in prompts]
    draft_solos = [[int(t) for t in draft.generate(
        [p], max_new_tokens=NEW_TOKENS)[0][len(p):]] for p in prompts]
    report["draftVsTargetSolo"] = _agreement(draft_solos, solos)
    paged = {"type": "lm", "kv": "paged", "maxSlots": 4, "cacheLen": 2048,
             "pageLen": PAGE_LEN, "temperature": 0.0}
    spec_bound = _spec_expectation([NEW_TOKENS] * len(prompts), SPEC_K)
    server = RestServer(port=0, context=ctx).start()
    base = server.base_url
    try:
        # (a) the target as its own draft
        _create(base, "lm", dict(paged, draft="lm", specK=SPEC_K))
        calls = _timed_calls(torch, ctx.serving._sessions["lm"],
                             ("_verify", "_draft_propose"))
        out, walls, wall = _predict_round(base, "lm", prompts)
        _diverges("self-draft spec", _round_tokens("self-draft spec", out),
                  solos)
        stats = _http(base, "GET", "/serve/lm")[1]
        per_step = stats["spec"]["acceptedTokensPerStep"]
        report["a"] = {"tokensEqualSolo": True, "spec": stats["spec"],
                       **{_CALL_KEYS[k]: _p50(v) for k, v in calls.items()},
                       "fullAcceptanceBound": spec_bound,
                       "shortfallBeyondClamp": spec_bound - per_step,
                       "wallSeconds": wall, **_round_rates(out, walls)}
        _http(base, "DELETE", "/serve/lm")

        # (b) a plain paged session, then disagg + spec with the draft,
        # each after a first-use round
        rates = {}
        for name, extra in (("paged", {}),
                            ("disaggSpec", {"disagg": True,
                                            "draft": "draft",
                                            "specK": SPEC_K})):
            resp = _create(base, "lm", dict(paged, **extra))
            session = ctx.serving._sessions["lm"]
            _round_tokens(f"{name} first use",
                          _predict_round(base, "lm", first_use)[0])
            calls = _timed_calls(torch, session, (
                "_verify", "_draft_propose") if extra else ("_pstep",))
            _reset_launches(attn)
            out, walls, wall = _predict_round(base, "lm", prompts)
            launches = _launches(attn)
            _diverges(name, _round_tokens(name, out), solos)
            stats = _http(base, "GET", "/serve/lm")[1]
            rates[name] = {"wallSeconds": wall, **_round_rates(out, walls),
                           **{_CALL_KEYS[k]: _p50(v)
                              for k, v in calls.items()}}
            _http(base, "DELETE", "/serve/lm")
            held = _prefix_held(session)
            free = session.pool.free_count()
            if free != resp["kv"]["pagesTotal"] - held:
                raise AssertionError(f"{name}: {free} pages free after "
                                     f"delete, the prefix cache holds "
                                     f"{held} of {resp['kv']['pagesTotal']}")
        n_req = len(prompts) + len(first_use)
        disagg = stats["disagg"]
        per_request = LM_CONFIG["n_layers"] + DRAFT_CONFIG["n_layers"]
        want = dict.fromkeys(COUNTERS, 0)
        want["flash_fwd_tf32x3"] = per_request * len(prompts)
        if disagg["mode"] != "colocated" or \
                disagg["handoffsTotal"] != n_req or \
                disagg["handoffQueue"] != 0 or \
                set(stats["roles"]) != {"prefill", "decode", "draft"}:
            raise AssertionError(f"disagg stats: {disagg}, roles "
                                 f"{sorted(stats['roles'])}")
        if launches != want:
            raise AssertionError(f"disagg + spec launched {launches}, want "
                                 f"{want} ({LM_CONFIG['n_layers']} a target "
                                 f"prefill, {DRAFT_CONFIG['n_layers']} a "
                                 f"draft prefill, none in verify or "
                                 f"propose)")
        report["b"] = {
            "launches": launches, "tokensEqualSolo": True,
            "disagg": disagg, "spec": stats["spec"],
            "draftMsPerRound": stats["roles"]["draft"],
            "fullAcceptanceBound": spec_bound, **rates}

        # (c) the handoff fault, transient then latched
        report["c"] = {}
        for spec, sends in (("kv_page_handoff:1", 1),
                            ("kv_page_handoff:100", 3)):
            ctx.config.fault_inject = spec
            faults.reset()
            try:
                resp = _create(base, "lm", dict(paged, disagg=True))
                session = ctx.serving._sessions["lm"]
                total = resp["kv"]["pagesTotal"]
                for _ in range(sends):
                    status, body = _http(base, "POST", "/serve/lm/predict",
                                         {"prompt": prompts[0],
                                          "maxNewTokens": NEW_TOKENS})
                    if status != 429 or session.pool.free_count() != total:
                        raise AssertionError(
                            f"{spec}: {status} {body}, "
                            f"{session.pool.free_count()} of {total} free")
                if sends == 3:
                    deadline = time.monotonic() + 30
                    while session.disagg_mode != "fused-degraded":
                        if time.monotonic() > deadline:
                            raise AssertionError("the latched handoff "
                                                 "fault never collapsed")
                        time.sleep(0.01)
                out, _, _ = _predict_round(base, "lm", prompts[:2])
                _diverges(spec, _round_tokens(spec, out), solos[:2])
                stats = _http(base, "GET", "/serve/lm")[1]
                _http(base, "DELETE", "/serve/lm")
                if session.pool.free_count() != \
                        total - _prefix_held(session):
                    raise AssertionError(f"{spec}: the pool leaked")
                want_mode = "fused-degraded" if sends == 3 else "colocated"
                if stats["disagg"]["mode"] != want_mode:
                    raise AssertionError(f"{spec}: {stats['disagg']}")
                report["c"][spec] = {"rejected": sends,
                                     "disagg": stats["disagg"],
                                     "poolLeakFree": True,
                                     "tokensEqualSolo": True}
            finally:
                ctx.config.fault_inject = ""
                faults.reset()

        # (d) decode cadence under a burst, fused then disaggregated
        # two lengths: the round timer tells the streams apart by them
        streams = [[int(t) for t in x[i, :CADENCE_PROMPT - PAGE_LEN * j]]
                   for j, i in enumerate(measured[:2])]
        burst = [[int(t) for t in x[i, 13:13 + BURST_PROMPT]]
                 for i in warm[:2]]
        want_c = [solo(p, CADENCE_NEW) for p in streams] + \
            [solo(p, 1) for p in burst]
        report["d"] = [_cadence(base, ctx, dict(paged, **extra),
                                streams, burst, want_c)
                       for extra in ({}, {"disagg": True})]

        # (e) int8 KV pages with the self-draft
        _create(base, "lm", dict(paged, kvDtype="int8", draft="lm",
                                 specK=SPEC_K))
        out, walls, _ = _predict_round(base, "lm", prompts)
        tokens = _round_tokens("int8 spec", out)
        stats = _http(base, "GET", "/serve/lm")[1]
        report["e"] = {"agreement": _agreement(tokens, solos),
                       "spec": stats["spec"], "kv": stats["kv"]["dtype"],
                       "drift": stats.get("drift"),
                       **_round_rates(out, walls)}
        _http(base, "DELETE", "/serve/lm")

        # (f) the classifier, bucketed
        os.environ["LO_COMPUTE_DTYPE"] = "bfloat16"
        ctx.artifacts.save(yard["clf"], "clf", "train/tensorflow")
        clf_x = yard["clfRows"]
        _create(base, "clf", {"type": "predict"})
        sent = []
        _reset_launches(attn)
        offset = 0
        for n, bucket in BUCKET_BURSTS:
            rows = clf_x[offset:offset + n]
            offset += n
            status, body = _http(base, "POST", "/serve/clf/predict",
                                 {"x": rows.tolist()})
            if status != 200 or body["bucket"] != bucket:
                raise AssertionError(f"bucketed {n} rows: {status} "
                                     f"{body.get('bucket')}")
            sent.append((rows, body))
        out = [None] * len(BUCKET_CLIENTS)
        chunks = []
        for n in BUCKET_CLIENTS:
            chunks.append(clf_x[offset:offset + n])
            offset += n

        def client(i):
            out[i] = _http(base, "POST", "/serve/clf/predict",
                           {"x": chunks[i].tolist()})

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(chunks))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        for rows, result in zip(chunks, out):
            if result is None or result[0] != 200:
                raise AssertionError(f"concurrent bucketed: {result}")
            sent.append((rows, result[1]))
        stats = _http(base, "GET", "/serve/clf")[1]
        clf_launches = _launches(attn)
        want = dict.fromkeys(COUNTERS, 0)
        want["flash_fwd_sm90"] = CLF_CONFIG["n_layers"] * \
            stats["predictsTotal"]
        if clf_launches != want:
            raise AssertionError(f"bucketed predict launched {clf_launches}"
                                 f", want {want}")
        _http(base, "DELETE", "/serve/clf")
        served = ctx.artifacts.load("clf")
    finally:
        server.stop()
        ctx.close()
    err, err_alone = 0.0, 0.0
    for rows, body in sent:
        n, bucket = len(rows), body["bucket"]
        got = np.asarray(body["predictions"], np.float32)
        if got.shape != (n, CLF_CONFIG["n_classes"]):
            raise AssertionError(f"bucketed answer shape {got.shape}")
        padded = np.concatenate([rows] + [rows[:1]] * (bucket - n))
        direct = served.predict(padded, batch_size=bucket)[:n]
        err = max(err, float(np.abs(got - direct).max()))
        err_alone = max(err_alone, float(np.abs(
            got - served.predict(rows, batch_size=n)).max()))
    if not err <= 1e-5:
        raise AssertionError(f"bucketed rows differ from a direct predict "
                             f"by {err}")
    report["f"] = {"buckets": [b["bucket"] for _, b in sent],
                   "maxAbsErrVsDirect": err,
                   "maxAbsErrVsUnpaddedPredict": err_alone,
                   "launches": clf_launches, "stats": {
                       k: stats[k] for k in ("predictsTotal", "rowsTotal",
                                             "batchFill", "perf")}}
    report["seconds"] = time.monotonic() - t0
    log.append("servingPlane " + json.dumps(report))
    return {"servingPlaneDraftFit": fit_launches,
            "servingPlaneDisaggSpec": report["b"]["launches"],
            "servingPlanePredict": clf_launches}


# ----------------------------------------------------------------------
# the keras path: NeuralModel (the tutorial's CNN and LSTM, ResNet-50)
# and the sweeps
# ----------------------------------------------------------------------
# docs/TUTORIAL.md workflow 2 (MNIST CNN) and workflow 3 (IMDb LSTM)
TUTORIAL_CNN = [
    {"kind": "reshape", "shape": [28, 28, 1]},
    {"kind": "conv2d", "filters": 32, "kernel": [3, 3],
     "activation": "relu"},
    {"kind": "maxpool2d"},
    {"kind": "flatten"},
    {"kind": "dense", "units": 128, "activation": "relu"},
    {"kind": "dense", "units": 10, "activation": "softmax"}]
TUTORIAL_LSTM = [{"kind": "embedding", "vocab": 20000, "dim": 128},
                 {"kind": "lstm", "units": 128},
                 {"kind": "dense", "units": 2, "activation": "softmax"}]
# MNIST's and IMDb's published shapes; data from seeds
MNIST_ROWS, MNIST_BATCH, MNIST_EPOCHS = 60000, 256, 2
IMDB_ROWS, IMDB_SEQ, IMDB_VOCAB, IMDB_BATCH = 25000, 200, 20000, 128
# the REST workflow's rows (two CSVs), its fit and the sweep over it
REST_ROWS, REST_EPOCHS = 1024, 2
SWEEP_GRID = {"learning_rate": [1e-3, 3e-4], "batch_size": [128, 256]}
CLF_SWEEP_GRID = {"learning_rate": [3e-4, 1e-3, 3e-3]}
# ResNet-50 (1000 classes, 224x224x3): 2 epochs of 4 steps at batch 64
RESNET_BATCH, RESNET_STEPS = 64, 8


def _mnist_like(np, n: int, seed: int):
    """``n`` rows of 784 pixels and labels: one of 10 fixed class
    templates (seed 1234) mixed with noise, quantized to k/256 (exact in
    a CSV of 8 decimals)."""
    templates = np.random.default_rng(1234).random((10, 784))
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 10, n).astype(np.int32)
    x = 0.6 * templates[y] + 0.4 * rng.random((n, 784))
    return (np.floor(x * 256) / 256).astype(np.float32), y


def _imdb_like(np, n: int, seed: int):
    """``n`` rows of 200 token ids in [1, 20000) and labels: whether an
    id below 1000 is among the last 10 (a task the LSTM's last state
    sees)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(1, IMDB_VOCAB, size=(n, IMDB_SEQ)).astype(np.int32)
    y = (x[:, -10:] < 1000).any(axis=1).astype(np.int32)
    return x, y


def _rel_l2(torch, got, want) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def _f32_step_vs_cpu(torch, body, x, y) -> dict:
    """One float32 micro-step of ``body`` from its seed-0 init on the card
    and on the CPU: the loss and each gradient's relative L2. (An init's
    loss and gradients are O(1); a fitted model's nearly cancel.)"""
    import numpy as np

    from learningorchestra_tpu_torch.models.neural import NeuralModel
    from learningorchestra_tpu_torch.runtime.data import MASK_KEY

    os.environ["LO_COMPUTE_DTYPE"] = "float32"
    out, params = {}, None
    try:
        for device in ("cuda", "cpu"):
            model = NeuralModel(body, device=device)
            if params is None:
                model._build_params(model._coerce_x(x))
                params = {k: v.detach().cpu()
                          for k, v in model.params.items()}
            else:
                model.set_params(params, input_shape=x.shape[1:])
            eng = model._get_engine()
            batch = eng._to_device(
                {"x": model._coerce_x(x), "y": y.astype(np.int64),
                 MASK_KEY: np.ones(len(x), np.float32)}, model.device)
            grads, _, metrics = eng._micro_step(model.params,
                                                model.model_state, batch, 0)
            s, c = metrics["loss"]
            out[device] = (float(s) / float(c), grads)
    finally:
        os.environ["LO_COMPUTE_DTYPE"] = "bfloat16"
    rel = {k: _rel_l2(torch, g, out["cpu"][1][k])
           for k, g in out["cuda"][1].items()}
    worst = max(rel, key=rel.get)
    loss_rel = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    if not (rel[worst] <= 1e-4 and loss_rel <= 1e-4):
        raise AssertionError(f"float32 step on the card vs the CPU: loss "
                             f"{loss_rel}, gradient of {worst} {rel[worst]}")
    return {"lossRel": loss_rel, "gradRelL2Max": rel[worst], "worst": worst}


def _profile_fit(torch, model, x, y, batch: int, steps: int = 3) -> dict:
    """A profiler window of ``steps`` optimizer steps of ``model``'s fit
    engine (after one warm step): wall, device busy time, idle share and
    the top kernels. Params and batch statistics are restored after."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    eng = model._get_engine()
    live = {**model.params, **model.model_state}
    saved = {k: t.detach().clone() for k, t in live.items()}
    tstate = eng.init_state(model.params, model.model_state)
    batches = [eng._to_device(b, model.device) for b in model._batcher(
        x[:(steps + 1) * batch], y[:(steps + 1) * batch], batch).epoch(0)]
    eng._train_step_body(tstate, batches[0], 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        w0 = time.monotonic()
        for b in batches[1:]:
            eng._train_step_body(tstate, b, 0)
        torch.cuda.synchronize()
        window_ms = (time.monotonic() - w0) * 1e3
    with torch.no_grad():
        for k, t in live.items():
            t.copy_(saved[k])
    del saved, tstate, batches
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = [[e.key[:80], e.self_device_time_total / 1e3 / steps,
            e.count / steps]
           for e in sorted(kernels, key=lambda e: e.self_device_time_total,
                           reverse=True)[:8]]
    names = sorted({e.key[:60] for e in kernels})
    del prof, kernels
    gc.collect()
    return {"steps": steps, "windowMs": window_ms, "deviceBusyMs": busy_ms,
            "idleShare": 1.0 - busy_ms / window_ms,
            "stepMs": window_ms / steps, "topKernelsMsPerStep": top,
            "kernelNames": names}


def _write_csv(np, path, header, x, fmt) -> None:
    np.savetxt(path, x, fmt=fmt, delimiter=",", header=",".join(header),
               comments="")


def neural_phase(torch, log, home, yard):
    """The keras path on the card (the ``neural`` line): (a) the
    tutorial's CNN fitted directly on 60000 MNIST-shaped rows (batch 256,
    2 epochs, bf16): the loss falls, accuracy well above chance, step
    time, samples/s and the idle share of a profiled window, and one
    float32 step on the card within 1e-4 of the CPU's; (b) workflow 2
    over HTTP: two CSVs of 1024 rows through ``POST /dataset/csv``,
    ``/model``, ``/train`` with ``"checkpoint": true`` (epoch losses equal
    to a direct fit's on the same rows), ``/evaluate``, ``/predict``
    (rows sum to 1) and a PATCH resume that trains epoch 2 as the
    uninterrupted fit does; (c) workflow 3's LSTM fitted directly on
    25000 rows of 200 ids (batch 128, 1 epoch, bf16): the loss falls, the
    RNN route and its kernels, and float32 steps of ``gru`` and
    ``bidirectional_lstm`` bodies against the CPU; (d) ResNet-50 (1000
    classes, 224x224x3) in bf16, batch 64, 8 steps: finite loss,
    batch statistics that move, ``predict`` rows that sum to 1, step
    time, images/s and peak memory; (e) the tune route: a GridSearch over
    (b)'s CNN (4 points and a refit, per-trial peak memory) and a
    RandomSearch of 2 points over the classifier phase's TextClassifier
    (flash, bf16) on 1024 rows of 512 tokens, whose sm90 launches must be
    exactly 4 layers x (optimizer steps of the trials and the refit),
    plus one forward a layer for each evaluate batch. Returns each
    path's kernel launches."""
    import numpy as np

    from learningorchestra_tpu_torch.config import Config
    from learningorchestra_tpu_torch.models import sequential_module as seq
    from learningorchestra_tpu_torch.models import sweep as sweep_lib
    from learningorchestra_tpu_torch.models.neural import NeuralModel
    from learningorchestra_tpu_torch.ops import attention as attn
    from learningorchestra_tpu_torch.services.context import ServiceContext
    from learningorchestra_tpu_torch.services.server import RestServer

    os.environ["LO_COMPUTE_DTYPE"] = "bfloat16"
    phase_t0 = time.monotonic()
    paths, out = {}, {}
    zero = dict.fromkeys(COUNTERS, 0)

    # (a) the tutorial CNN, direct
    x, y = _mnist_like(np, MNIST_ROWS, seed=0)
    cnn = NeuralModel(TUTORIAL_CNN, device="cuda")
    _reset_launches(attn)
    t0 = time.monotonic()
    hist = cnn.fit(x, y, batch_size=MNIST_BATCH,
                   epochs=MNIST_EPOCHS).history
    fit_s = time.monotonic() - t0
    paths["neuralCnn"] = _launches(attn)
    evaluated = cnn.evaluate(x[:10000], y[:10000], batch_size=1024)
    if not (hist["loss"][1] < hist["loss"][0] and
            evaluated["accuracy"] > 0.5 and paths["neuralCnn"] == zero):
        raise AssertionError(f"the CNN fit: {hist}, evaluate {evaluated}, "
                             f"launches {paths['neuralCnn']}")
    steps = -(-MNIST_ROWS // MNIST_BATCH)
    out["cnn"] = {
        "rows": MNIST_ROWS, "batch": MNIST_BATCH, "epochs": MNIST_EPOCHS,
        "params": cnn.num_params(), "history": hist, "fitSeconds": fit_s,
        "evaluate": evaluated,
        "stepMsEpoch2": hist["epochSeconds"][-1] / steps * 1e3,
        "samplesPerSecEpoch2": hist["samplesPerSecond"][-1],
        "profile": _profile_fit(torch, cnn, x, y, MNIST_BATCH),
        "f32StepVsCpu": _f32_step_vs_cpu(torch, TUTORIAL_CNN,
                                         x[:MNIST_BATCH], y[:MNIST_BATCH])}
    del out["cnn"]["profile"]["kernelNames"]
    del cnn, x, y
    gc.collect()

    # (b) workflow 2 over HTTP, and (e) the tune route on its server
    rx, ry = _mnist_like(np, REST_ROWS, seed=1)
    pix_csv = os.path.join(home, "pixels.csv")
    lab_csv = os.path.join(home, "labels.csv")
    _write_csv(np, pix_csv, [f"p{i}" for i in range(784)], rx, "%.8f")
    _write_csv(np, lab_csv, ["label"], ry[:, None], "%d")
    direct = NeuralModel(TUTORIAL_CNN, device="cuda")
    want = direct.fit(rx, ry, batch_size=MNIST_BATCH,
                      epochs=REST_EPOCHS).history["loss"]
    ctx = ServiceContext(Config(home=os.path.join(home, "lo")),
                         device="cuda")
    server = RestServer(port=0, context=ctx).start()
    base = server.base_url
    trial_mem = []
    real_trial = sweep_lib.GridSearch._run_trial

    def measured_trial(self, combo, *args, **kwargs):
        # what is live as a trial starts (the sweep collects each trial's
        # model after it), and the trial's own peak above that
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        result = real_trial(self, combo, *args, **kwargs)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        trial_mem.append({"params": combo, "beforeBytes": before,
                          "peakBytes": peak, "trialPeakBytes": peak - before})
        return result

    def post(path, body, status=201):
        got, answer = _http(base, "POST", path, body)
        if got != status:
            raise AssertionError(f"POST {path}: {got} {answer}")
        return answer

    def run(verb, name, parent, method, params):
        post(f"/{verb}/tensorflow", {"name": name, "modelName": parent,
                                     "method": method,
                                     "methodParameters": params})
        return _poll(base, f"/{verb}/tensorflow/{name}")

    def docs(verb, name):
        return _http(base, "GET", f"/{verb}/tensorflow/{name}")[1]["result"]

    def model(name, cls, params):
        post("/model/tensorflow", {"modelName": name, "modulePath":
                                   "learningorchestra_tpu.models",
                                   "class": cls, "classParameters": params})
        _poll(base, f"/model/tensorflow/{name}")

    sweep_lib.GridSearch._run_trial = measured_trial
    try:
        t0 = time.monotonic()
        for name, path in (("pixels", pix_csv), ("labels", lab_csv)):
            post("/dataset/csv", {"datasetName": name, "datasetURI": path})
            _poll(base, f"/dataset/csv/{name}")
        ingest_s = time.monotonic() - t0
        model("cnn", "NeuralModel", {"layer_configs": TUTORIAL_CNN})
        fit = {"x": "$pixels", "y": "$labels", "epochs": REST_EPOCHS,
               "batch_size": MNIST_BATCH, "checkpoint": True}
        _reset_launches(attn)
        t0 = time.monotonic()
        meta = run("train", "cnn_t", "cnn", "fit", fit)
        train_s = time.monotonic() - t0
        paths["neuralRest"] = _launches(attn)
        got = [d["epochRecord"]["loss"] for d in docs("train", "cnn_t")
               if "epochRecord" in d]
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        if len(got) != REST_EPOCHS or not rel <= 1e-5 or \
                len(meta.get("checkpointCommits", [])) != REST_EPOCHS:
            raise AssertionError(f"REST fit losses {got} against the "
                                 f"direct fit's {want}; metadata {meta}")
        run("evaluate", "cnn_e", "cnn_t", "evaluate",
            {"x": "$pixels", "y": "$labels", "batch_size": MNIST_BATCH})
        ev = next(d["result"] for d in docs("evaluate", "cnn_e")
                  if "result" in d)
        run("predict", "cnn_p", "cnn_t", "predict",
            {"x": "$pixels", "batch_size": MNIST_BATCH})
        probs = np.asarray(ctx.artifacts.load("cnn_p"))
        row_err = float(np.abs(probs.sum(axis=1) - 1.0).max())
        if probs.shape != (REST_ROWS, 10) or not row_err <= 1e-5:
            raise AssertionError(f"predict: shape {probs.shape}, max |sum "
                                 f"- 1| {row_err}")
        # resume: 1 epoch, then PATCHed to 2 from its checkpoint
        run("train", "cnn_r", "cnn", "fit", dict(fit, epochs=1))
        status, answer = _http(base, "PATCH", "/train/tensorflow/cnn_r",
                               {"methodParameters": fit})
        if status != 200:
            raise AssertionError(f"PATCH cnn_r: {status} {answer}")
        meta_r = _poll(base, "/train/tensorflow/cnn_r")
        resumed = [d["epochRecord"]["loss"] for d in docs("train", "cnn_r")
                   if "epochRecord" in d]
        resume_rel = abs(resumed[-1] - got[-1]) / abs(got[-1])
        if not resume_rel <= 1e-5 or not meta_r.get("checkpointRestores"):
            raise AssertionError(f"the resumed epoch 2 lost {resumed[-1]}, "
                                 f"the uninterrupted {got[-1]}; {meta_r}")
        out["rest"] = {
            "rows": REST_ROWS, "ingestSeconds": ingest_s,
            "trainJobSeconds": train_s, "losses": got, "directLosses": want,
            "bitEqualToDirect": got == want, "maxRelToDirect": rel,
            "checkpointCommits": len(meta["checkpointCommits"]),
            "evaluate": ev, "predictRowSumMaxErr": row_err,
            "resumedEpoch2Loss": resumed[-1],
            "resumedBitEqual": resumed[-1] == got[-1],
            "restoredStep": meta_r["checkpointRestores"][-1]["step"]}

        # (e) the GridSearch over $cnn through /model and /tune
        model("sweep", "GridSearch", {"estimator": "$cnn",
                                      "param_grid": SWEEP_GRID})
        _reset_launches(attn)
        t0 = time.monotonic()
        meta_s = run("tune", "sweep_t", "sweep", "fit",
                     {"x": "$pixels", "y": "$labels", "epochs": 1})
        sweep_s = time.monotonic() - t0
        paths["neuralGridSearch"] = _launches(attn)
        swept = ctx.artifacts.load("sweep_t")
        points = len(swept.cv_results_["params"])
        if points != 4 or swept.best_estimator_ is None or \
                swept.best_params_ not in swept.cv_results_["params"] or \
                meta_s.get("sweepFusion", {}).get("fusedTrials") != 0 or \
                paths["neuralGridSearch"] != zero:
            raise AssertionError(f"the grid sweep: {swept.cv_results_}, "
                                 f"metadata {meta_s}")
        grid_mem = list(trial_mem)
        befores = [m["beforeBytes"] for m in grid_mem]
        leaked = max(befores) - min(befores)
        by_batch = {}
        for m in grid_mem:
            by_batch.setdefault(m["params"]["batch_size"], []).append(
                m["trialPeakBytes"])
        spread = max(max(v) / min(v) - 1 for v in by_batch.values())
        if leaked > 1 << 20 or spread > 0.1:
            raise AssertionError(f"trial memory not flat: {grid_mem}")

        # (e) a RandomSearch over the tutorial TextClassifier (flash)
        cx, cy = _marker_rows(np, CLF_ROWS, CLF_SEQ,
                              CLF_CONFIG["vocab_size"], seed=0)
        tok_csv = os.path.join(home, "clf_rows.csv")
        _write_csv(np, tok_csv, [f"t{i}" for i in range(CLF_SEQ)], cx, "%d")
        _write_csv(np, os.path.join(home, "clf_labels.csv"), ["label"],
                   cy[:, None], "%d")
        for name in ("clf_rows", "clf_labels"):
            post("/dataset/csv", {"datasetName": name, "datasetURI":
                                  os.path.join(home, f"{name}.csv")})
            _poll(base, f"/dataset/csv/{name}")
        model("clf", "TextClassifier", dict(CLF_CONFIG, attention="flash"))
        model("rsweep", "RandomSearch", {"estimator": "$clf", "param_grid":
                                         CLF_SWEEP_GRID, "n_iter": 2})
        _reset_launches(attn)
        t0 = time.monotonic()
        meta_rs = run("tune", "rsweep_t", "rsweep", "fit",
                      {"x": "$clf_rows", "y": "$clf_labels", "epochs": 1,
                       "batch_size": CLF_BATCH})
        rsweep_s = time.monotonic() - t0
        paths["neuralRandomSearch"] = _launches(attn)
        rswept = ctx.artifacts.load("rsweep_t")
        n_val = int(CLF_ROWS * 0.2)
        trial_steps = -(-(CLF_ROWS - n_val) // CLF_BATCH)
        eval_batches = -(-n_val // CLF_BATCH)
        refit_steps = -(-CLF_ROWS // CLF_BATCH)
        layers = CLF_CONFIG["n_layers"]
        optimizer_steps = 2 * trial_steps + refit_steps
        want_rs = dict(zero)
        want_rs.update(dict.fromkeys(
            ("flash_bwd_dq_sm90", "flash_bwd_dkv_sm90"),
            layers * optimizer_steps))
        want_rs["flash_fwd_sm90"] = layers * (optimizer_steps +
                                              2 * eval_batches)
        if paths["neuralRandomSearch"] != want_rs or \
                len(rswept.cv_results_["params"]) != 2:
            raise AssertionError(f"the classifier sweep launched "
                                 f"{paths['neuralRandomSearch']}, want "
                                 f"{want_rs}; {rswept.cv_results_}")
        out["tune"] = {
            "gridSearch": {
                "grid": SWEEP_GRID, "epochs": 1, "seconds": sweep_s,
                "cvResults": swept.cv_results_,
                "bestParams": swept.best_params_,
                "bestScore": swept.best_score_,
                "sweepFusion": meta_s["sweepFusion"],
                "trialMemory": grid_mem, "leakedBytes": leaked,
                "peakSpreadSameBatch": spread},
            "randomSearch": {
                "grid": CLF_SWEEP_GRID, "nIter": 2, "seconds": rsweep_s,
                "cvResults": rswept.cv_results_,
                "bestParams": rswept.best_params_,
                "sweepFusion": meta_rs["sweepFusion"],
                "launches": paths["neuralRandomSearch"],
                "trialMemory": trial_mem[len(grid_mem):],
                "launchFormula": f"bwd = {layers} layers x (2 trials x "
                                 f"{trial_steps} + refit {refit_steps}) "
                                 f"steps = {layers * optimizer_steps}; "
                                 f"fwd = that + {layers} x 2 trials x "
                                 f"{eval_batches} evaluate batches = "
                                 f"{want_rs['flash_fwd_sm90']}"}}
    finally:
        sweep_lib.GridSearch._run_trial = real_trial
        server.stop()
        ctx.close()
    del direct, swept, rswept
    gc.collect()

    # (c) workflow 3's LSTM, direct
    ix, iy = _imdb_like(np, IMDB_ROWS, seed=0)
    lstm = NeuralModel(TUTORIAL_LSTM, device="cuda")
    lstm._build_params(lstm._coerce_x(ix[:1]))
    last = (ix[-1024:], iy[-1024:])
    before = lstm.evaluate(*last, batch_size=1024)["loss"]
    _reset_launches(attn)
    hist = lstm.fit(ix, iy, batch_size=IMDB_BATCH, epochs=1).history
    paths["neuralLstm"] = _launches(attn)
    after = lstm.evaluate(*last, batch_size=1024)["loss"]
    if not (np.isfinite(hist["loss"][0]) and after < before and
            paths["neuralLstm"] == zero):
        raise AssertionError(f"the LSTM fit: the last rows' loss {before} "
                             f"-> {after}, {hist}")
    prof = _profile_fit(torch, lstm, ix, iy, IMDB_BATCH)
    rnn_kernels = [k for k in prof.pop("kernelNames")
                   if any(w in k for w in ("RNN", "LSTM", "GRU", "rnn"))]
    small = (ix[:32], iy[:32])
    f32 = {}
    for name, body in (("gru", [TUTORIAL_LSTM[0],
                                {"kind": "gru", "units": 128},
                                TUTORIAL_LSTM[2]]),
                       ("bidirectional_lstm", [
                           TUTORIAL_LSTM[0],
                           {"kind": "bidirectional_lstm", "units": 128},
                           TUTORIAL_LSTM[2]])):
        f32[name] = _f32_step_vs_cpu(torch, body, *small)
    out["lstm"] = {
        "rows": IMDB_ROWS, "seq": IMDB_SEQ, "batch": IMDB_BATCH,
        "route": seq.rnn_route("lstm"), "routeKernels": rnn_kernels,
        "history": hist, "lastRowsLossBeforeAfter": [before, after],
        "samplesPerSec": hist["samplesPerSecond"][0],
        "stepMs": hist["epochSeconds"][0] / -(-IMDB_ROWS // IMDB_BATCH)
        * 1e3, "profile": prof, "f32StepVsCpu": f32}
    if not rnn_kernels:
        raise AssertionError("the LSTM's profile shows no RNN kernel")
    del lstm, ix, iy
    gc.collect()

    # (d) ResNet-50
    rng = np.random.default_rng(0)
    images = RESNET_BATCH * RESNET_STEPS // 2
    rx = rng.standard_normal((images, 224, 224, 3), dtype=np.float32)
    ry = rng.integers(0, 1000, images).astype(np.int32)
    net = NeuralModel([{"kind": "resnet50"},
                       {"kind": "activation", "fn": "softmax"}],
                      device="cuda")
    net._build_params(rx[:1])
    stats0 = {k: v.clone() for k, v in net.model_state.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches(attn)
    hist = net.fit(rx, ry, batch_size=RESNET_BATCH, epochs=2,
                   shuffle=False).history
    paths["neuralResnet"] = _launches(attn)
    peak = torch.cuda.max_memory_allocated()
    moved = sum(not torch.equal(v, stats0[k])
                for k, v in net.model_state.items())
    probs = net.predict(rx[:RESNET_BATCH], batch_size=RESNET_BATCH)
    row_err = float(np.abs(probs.sum(axis=1) - 1.0).max())
    if not (all(np.isfinite(hist["loss"])) and moved == len(stats0) and
            probs.shape == (RESNET_BATCH, 1000) and row_err <= 1e-5 and
            paths["neuralResnet"] == zero):
        raise AssertionError(f"ResNet-50: {hist}, {moved} of {len(stats0)} "
                             f"statistics moved, predict {probs.shape} "
                             f"{row_err}")
    step_ms = hist["epochSeconds"][-1] / (RESNET_STEPS // 2) * 1e3
    out["resnet50"] = {
        "batch": RESNET_BATCH, "steps": RESNET_STEPS, "params":
        net.num_params(), "history": hist, "stepMsEpoch2": step_ms,
        "imagesPerSecEpoch2": RESNET_BATCH / step_ms * 1e3,
        "peakBytes": peak, "statsMoved": moved,
        "predictRowSumMaxErr": row_err}
    del net, rx
    gc.collect()
    out["phaseSeconds"] = time.monotonic() - phase_t0
    log.append("neural " + json.dumps(out))
    return paths


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from learningorchestra_tpu_torch.ops import _build
    except ImportError as exc:
        print(f"chip_smoke: the port is not beside this script: {exc}",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(f"device: {smi.stdout.strip()}", flush=True)
    t0 = time.monotonic()
    _build.build()
    print(f"kernel build seconds: {time.monotonic() - t0:.3f} "
          f"(sources {_build.sources()})", flush=True)
    ptxas = {name: _ptxas_report(text)
             for name, text in sorted(_build.BUILD_LOG.items())}
    print("ptxas " + json.dumps(ptxas), flush=True)
    spilled = [v for name, variants in ptxas.items()
               if name.endswith(("_sm90", "_tf32x3"))
               for v in variants if v.get("spillStores", 1)
               or v.get("spillLoads", 1)]
    if spilled:
        print(f"chip_smoke: tensor-core variants spill (or ptxas did not "
              f"report): {spilled}", file=sys.stderr)
        return 1

    log: list = []
    if "--only" in sys.argv:
        # iteration aid: the build, then the named self-contained phases
        # alone; no kernels line and no result line
        phases = {"neural": neural_phase}
        try:
            for name in sys.argv[sys.argv.index("--only") + 1].split(","):
                with tempfile.TemporaryDirectory() as home:
                    launched = phases[name](torch, log, home, {})
                print(f"{name} launches " + json.dumps(launched))
        except BaseException:
            for line in log:
                print(line)
            traceback.print_exc()
            return 1
        for line in log:
            print(line)
        return 0
    try:
        entries = kernel_phase(torch, log)
        entries.update(bwd_kernel_phase(torch, log))
        serve_yard: dict = {}
        with tempfile.TemporaryDirectory() as home:
            served = slice_phase(torch, log, home, serve_yard)
        with tempfile.TemporaryDirectory() as home:
            paged = paged_phase(torch, log, home, serve_yard)
        del serve_yard
        yard: dict = {}
        with tempfile.TemporaryDirectory() as home:
            paths = {"serve": served, **paged,
                     **train_phase(torch, log, home, yard)}
        with tempfile.TemporaryDirectory() as home:
            paths.update(pipeline_phase(torch, log, home, yard))
        with tempfile.TemporaryDirectory() as home:
            paths.update(lm_options_phase(torch, log, home, yard))
        with tempfile.TemporaryDirectory() as home:
            paths.update(classifier_phase(torch, log, home, yard))
        with tempfile.TemporaryDirectory() as home:
            paths.update(serving_plane_phase(torch, log, home, yard))
        del yard
        with tempfile.TemporaryDirectory() as home:
            paths.update(neural_phase(torch, log, home, {}))
        # each kernel's main path: serving (float32) for the split-TF32
        # forward, the bf16 fit for the wgmma kernels, the float32 fit for
        # the split-TF32 backward
        main_path = {"flash_fwd_sm90": "train",
                     "flash_bwd_dq_sm90": "train",
                     "flash_bwd_dkv_sm90": "train",
                     "flash_fwd_tf32x3": "serve",
                     "flash_bwd_dq_tf32x3": "trainFloat32",
                     "flash_bwd_dkv_tf32x3": "trainFloat32"}
        missing = [name for name, path in main_path.items()
                   if name not in entries or not paths[path][name]]
        if missing:
            raise AssertionError(f"kernels never measured or never launched "
                                 f"on their path: {missing}")
    except BaseException:
        for line in log:
            print(line)
        traceback.print_exc()
        return 1
    # the line of each TPU kernel (learningorchestra_tpu/ops/attention.py)
    replaces = {"fwd": 188, "bwd_dq": 338, "bwd_dkv": 402}
    kernels = []
    for name in COUNTERS:
        op, tensor_core_route = name[len("flash_"):].rsplit("_", 1)
        entry = entries[name]
        path = main_path[name]
        # route: the kernel's language (CUDA C++, no Triton);
        # tensorCoreRoute: the port's route that launches it (_route)
        entry.update({
            "name": name, "route": "cuda",
            "tensorCoreRoute": tensor_core_route,
            "source": f"learningorchestra_tpu_torch/csrc/{name}.cu",
            "replaces": f"learningorchestra_tpu/ops/attention.py:"
                        f"{replaces[op]}",
            "launches": paths[path][name], "mainPath": path,
            "launchesByPath": {p: c[name] for p, c in paths.items()}})
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    for line in log:
        print(line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
