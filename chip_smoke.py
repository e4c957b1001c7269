#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases, each fatal on failure:
  1. device: needs CUDA; prints the card's name and power limit; TF32 off
     (fp32 products stay fp32, or fp32 parity would mean nothing);
  2. build: compiles the eight kernel sources from
     ``src/repro_torch/kernels/csrc`` (one nvcc each, in parallel) and prints
     ``-Xptxas -v``'s summary, and its lines for the attention kernels on
     the tensor cores (``fwd_tc_kernel``, ``fwd_tf32_kernel``,
     ``dq_tc_kernel``, ``dkv_tc_kernel``, ``dq_tf32_kernel``,
     ``dkv_tf32_kernel``: registers, spills), and one line (registers,
     shared memory, spills) per instantiation of the paged kernels
     (``paged_decode_kernel``, ``prefill_tc_kernel``,
     ``prefill_tf32_kernel``);
  3. kernels: each of the thirteen kernels against its plain PyTorch
     version on the card, at the serving and training paths' shapes (max
     |err| <= 2e-4 + 2e-4 |ref| for fp32 outputs from identical inputs,
     summed in another order; a bf16 output may also differ by its one
     final rounding, 2^-7 |ref|), timed by CUDA-graph replay (the
     gate-residual forward and its library call as the median of three
     readings) beside its bound (fp32 attention at the larger of the fp32
     and the 3xTF32 tensor-core rate), the plain version and, where one
     PyTorch call computes the same function, that call (the bf16
     attention dq and dk/dv, the fp32 forward, dq and dk/dv at DiT's shape,
     the gate-residual forward's (d) fp32 and (m) cases, decode (a),
     prefill (c) in bf16 and in fp32 and the ln-modulate forward's main
     case also printed beside the times PERF.md records for their
     predecessors, which this run does not measure, and DiT's fp32 dq +
     dk/dv beside SDPA's whole backward); the paged kernels at stablelm's
     (a, c) and h2o-danube3's (b) shapes, each case with the kernel it ran
     (prefill (c) through both routes: bf16 q and pages on the bf16
     tensor-core kernel; fp32 q over fp32 pages and over int8 pages, the
     fp32 and fp32_kvint8 policies, on the 3xTF32 one); the row-wise
     kernels (ln-modulate, gate-residual backward, EDM loss; each AdaLN
     kernel's launch plan printed) and the attention calls of a two-pass
     layer at olmo-1b's shapes; a ragged causal attention case
     at S=1000 in bf16;
     the Euler step forward and backward at the DiT sampler's (256, 256, 16)
     and the recurrent sampler's (8, 512, 512) with F strided, in bf16 and
     at a ragged S, plus one ``torch.autograd.grad`` through
     ``fused_euler`` (the backward kernel must run); the kernels of the
     DiT-S/2 step at its shapes (attention ``full`` B=256 H=6 S=256 hd 64,
     gate-residual forward and backward (256, 256, 384), EDM loss
     (256, 256, 16), fp32), Huginn's attention (causal and db_concat,
     B=8 H=8 hd 64, fp32), ViT's (attention ``full`` B=128 H=4 S=66 at
     hd 32, the fp32 kernels' hd-32 instantiations; the Euler step at
     predict's (128, 1, 128) with F the label row of the stream) and the
     MDM's (attention ``full`` B=64 H=12 S=256 hd 64, gate-residual forward
     and backward (64, 256, 768), fp32), and llama-3.2-vision-11b's (r):
     decode KV=8 G=4 hd 128 with the probe's fp32 q over bf16 pages at
     phase 4's lengths, the bf16 prefill chunk on the tensor cores, the
     gate-residual forward (8, 1, 4096) fp32; and zamba2-7b's (z) at hd
     112: decode B=8 KV=32 G=1 with fp32 q over bf16 pages under the 4096
     window at phase 4's lengths (the hybrid's probe and commit), the
     prefill chunk the same on the 3xTF32 route, decode and prefill with
     fp32 q over int8 pages under a 64-key window the lengths pass, the
     bf16 prefill on the tensor cores, the gate-residual forward (8, 1,
     3584) fp32, and the fp32 attention kernels' hd-112 instantiations at
     its training shapes (window 4096 B=4 H=32 S=512, and two_pass with
     512 queries over 2 x 512 keys); and h2o-danube3-4b's (s): the
     attention kernels at hd 120 (hd 128's tiles, a zero pad) with 32 query
     heads on 8 KV heads, bf16 db_concat B=8 S=2 x 512 (its DB step) and
     the same in fp32 (its fp32 check), bf16 two_pass 512 over 2 x 512
     keys, bf16 window 4096 at S=512 (its e2e step), and (g)'s window-256
     shape at S=1024 in both dtypes, whose window binds; and
     whisper-small's (w): the ``full`` kind at hd 64, 12 heads, B=8, the
     encoder at S=1500 (the last key tile 28 keys long) and the
     cross-attention at 896 queries (the DB concat stream of 2 x 448) over
     1500 keys, in both dtypes, each beside SDPA; and
     llama-3.2-vision-11b's cross layer in training (x): the ``full`` kind
     with 32 query heads on 8 KV heads of 128 at 1024 (the DB concat
     stream) and 512 queries over 1601 image tokens (the last key tile
     one key long), in both dtypes, beside SDPA, and the gate-residual
     forward and backward at the two-pass stream's (4, 512, 4096) bf16;
     and xlstm-125m's (u): the gate-residual forward at its probes' (8, 1,
     768) fp32;
  4. serve: stablelm-1.6b at full width (24 layers, d=2048), DEFAULT_DB
     (4 blocks), random weights from seed 0 with the AdaLN heads randomised,
     bf16 policy, greedy, 8 requests with prompts padded to 512 (ragged
     128-512), chunk 64, 32 new tokens; the launch counters of that run must
     equal the path's arithmetic;
  5. cross-check: the fp32 policy's prefill of phase 4's prompts through
     the kernels (the 3xTF32 prefill route; after a warm-up, under the
     profiler: device busy ms and the prefill kernel's ms, launch counts
     checked) and through their plain versions (``impl="ref"``), the
     committed pools (pages 1 and up: padding writes the trash page)
     within 1e-3 relative; one fp32 serve step from the kernels' pool and
     one z, through the kernels and through their plain versions; logits
     must agree to 1e-3 relative. Then its bf16 counterpart: the prefill
     (the tensor-core prefill route) and one serve step through the kernels,
     and both again through the plain versions, from the same z; the
     first-step logits within 5e-2 x max|ref| (the bound
     tests/test_torch_serve.py holds bf16 first-step logits to), greedy
     agreement printed;
 5b. continuous: the same model served by ``ContinuousBatcher`` (bf16,
     greedy, 8 slots, page 16, chunk 64, seg_len 16, prefix cache on): 32
     ``MarkovLM`` prompts from seed 1, ragged over 128-512 tokens, the even
     ones behind one shared 256-token prefix, all submitted before the
     first step, 64 new tokens each; the decode segments replayed from one
     CUDA graph (captured before the clock). Wall, tok/s, TTFT median and
     max (host clock), ms per segment step and per chunk dispatch (CUDA
     events) and the share of the wall spent inside a dispatch, dispatches,
     prefix hits, shared tokens, CoW copies, pool MB by dtype; the
     device-busy share under the profiler over a window, the graphed run
     of the graph-against-eager check below. Fatal:
     a request short of its 64 tokens, a page not back on the free list
     (beyond the prefix cache's own refs), launch counts other than 2 · 24
     paged decodes and gate-residuals a segment step and 24 prefills a
     chunk dispatch; the first 4 segments replayed from the graph and run
     eagerly (same schedule and draws) not giving identical tokens and
     bit-equal pools; the same queue on a pool at 60% of the worst case
     (the 8 interactive requests submitted after 2 steps) without a
     preemption and a restore, or with a request short or a page leaked;
     8 requests under the fp32 policy for 2 segments through the kernels
     and through ``impl="ref"`` with the first segment's logits (steps up
     to the first token that differs) past 1e-3 relative. Prints the
     greedy agreement, and the bf16 and int8-pool top-1 agreement with
     fp32 on the same schedule and draws;
 5c. the serving system: ``InferenceServer`` (HTTP/SSE on 127.0.0.1, an
     ephemeral port) over ``ContinuousBatcher``s whose graphs its engine
     thread captures before it listens and replays; clients are the port's
     ``stream_generate`` on an event loop in the main thread. Parity: two
     requests one at a time through a one-slot fp32 server at stablelm's
     widths with 4 layers, bit-equal to a direct graphed ``step()`` loop
     under the same generator seed, and a ``"stream": false`` twin equal to
     its SSE stream. Then phase 5b's model, bf16, 8 slots, seg_len 16,
     prefix cache on: trace A, 48 requests arriving Poisson at 60% of the
     requests/s phase 5b finished; trace B, the same shape in geometric
     bursts (mean 4) at 150%, with ``max_queue`` 8 and a shed below an
     eighth of the pool's pages; prompts clipped-lognormal in 128-512
     tokens (median 256), a quarter behind one 256-token prefix, 16-64 new
     tokens (median 32), 20% interactive (TTFT SLO 2 s, TPOT 100 ms), 60%
     standard, 20% batch. Per trace and class: TTFT and TPOT p50 and p99
     (client clock), sheds (each 429 must carry ``Retry-After``), deadline
     cancels, preemptions, SLO attainment, tok/s and the wall's share
     inside a dispatch (CUDA events). Faults: a mid-stream cancel, a
     closed connection, a slow consumer of the bridge (paused at least
     once, its 64 tokens complete) and an injected ``engine_crash`` while
     four requests stream (one restart; each request exactly its tokens,
     what it streamed a prefix of its output). Drain: the requests in
     flight complete, a new one gets 503, the pool ends whole (free pages
     and the prefix cache's refs make it); launch counts equal the
     dispatches' arithmetic (each capture's warm-up step included); with
     the servers dropped and no gc pass, memory allocated within 0.5 GiB
     of its value before the phase;
 5d. disaggregated serving: ``InferenceServer`` over a ``DisaggRouter``.
     Parity: two requests one at a time through one-slot fp32 routers (1
     prefill + 1 decode worker, stablelm's widths with 4 layers), in
     ``copy`` and ``pages`` modes, bit-equal to a direct graphed step loop
     under the same generator seed (decode0's). Then phase 5b's model,
     bf16: 1 prefill worker (prefix cache on) and 2 decode workers of 8
     slots, seg_len 16, chunk 64, page-handle migration on one shared
     pool, every worker's graphs captured in the router's start; 5c's
     trace A (same seed and rate) over HTTP, per class TTFT and TPOT p50
     and p99, tok/s, migrations and the wall's share inside a dispatch,
     beside 5c's unified numbers; then trace A again without SLOs, with
     decode0 killed (``worker_die``) mid-trace and restarted after 1 s, one
     handoff dropped and one stalled past the handoff timeout: every
     request must end with all its tokens, failovers >= 1, drops 1,
     retries >= 1, one restart and no capture after the start. A short
     full-width ``copy`` run (1 + 1 workers, separate pools, 4 requests at
     once). Pools whole after each router, launch counts equal to the
     dispatches' arithmetic, peak memory printed, and with the routers
     dropped and no gc pass memory allocated within 0.1 GiB of its value
     before the phase;
  6. train: the same model, bf16 policy, MarkovLM batches of 8 x 512 (the
     memory resident at its start beside the fp32 masters; fatal if the
     serving phases left more than 1 GiB or a batcher behind): one
     DiffusionBlocks step on each of the 4 blocks (each block with its own
     AdamW state, freed after its step), one iteration of ``train_db``
     (every block's state resident), then one end-to-end step; loss,
     wall and device time and peak memory of each, the DB steps' wall as
     median and min-max over the blocks; launch counts equal to
     the path's arithmetic (one attention forward, dq and dk/dv per layer);
     finite losses; params change only in the trained block and the
     periphery;
  7. train cross-check: one fp32 DB step on block 0 through the kernels and
     through the plain attention; loss, grad norm and one layer's gradient
     agree to 1e-3 relative;
  8. two-pass l2 train: stablelm freed first; olmo-1b at full width (16
     layers, d=2048, 16 heads of 128, non-parametric LayerNorm), random
     weights from seed 0 with the AdaLN heads randomised,
     ``DBConfig(num_blocks=4, overlap_gamma=0.1, causal_mode="two_pass",
     loss="l2")``, bf16 policy, MarkovLM batches of 8 x 512: one DB step per
     block and one ``train_db`` iteration; loss, wall and device time (the
     DB steps' wall as median and min-max), peak memory, device-busy share
     under the profiler; launch counts equal to
     the path's arithmetic (per layer two attention calls, two ln-modulate
     and two gate-residual calls on the noisy stream, forward and backward;
     one EDM loss forward and backward); finite losses; params change only
     in the trained block and the periphery;
  9. two-pass cross-check: one fp32 two-pass l2 DB step on block 0 through
     the kernels and through the plain versions (``impl="ref"``); loss,
     grad norm and one layer's gradients agree to 1e-3 relative;
 10. DiT-S/2 (paper §5.2) at full width (12 layers, d=384, 6 heads of 64,
     LayerNorm, gelu; ``DIT_DB``: 3 blocks of 4, l2), 256 tokens of 16
     dims (a 32x32x4 latent, patch 2), fp32, olmo freed first: one DB step
     per block and one e2e step at batch 256 of
     ``MixtureImagesContinuous`` (wall, device busy, peak memory; launch
     counts per step: attention 4 or 12 per kernel, gate-residual 8 or 24
     forward and backward, EDM loss 1/1), Euler sampling of 256 samples in
     18 steps, blockwise (72 layer evaluations) and full stack (216), with
     launch counts of attention forward = layer evaluations, gate-residual
     twice that, Euler 18; one fp32 DB step on block 0 at batch 256 with σ
     from block 0's range, through the kernels against ``impl="ref"``
     within 1e-3;
 11. Huginn (paper §5.5) at full width (prelude 2, core 4, coda 2, d=512,
     8 heads of 64, rmsnorm, swiglu, vocab 32000, K=32, bptt_k 8), fp32,
     MarkovLM batches of 8 x 512: one ``db_loss`` step (attention 8 per
     kernel) and one ``baseline_loss`` step (132 forward, 36 dq and dk/dv),
     each also as one fp32 step of every param through the kernels against
     ``impl="ref"`` within 1e-3 (loss, grad norm, the first core layer's
     moments), then ``db_generate_logits`` with 32 Euler steps (132
     attention forward, 32 Euler), its logits within 1e-3 of the plain
     versions';
 12. ViT (paper §5.1) at full width (``VIT_CIFAR``: 12 layers, d=128, 4
     heads of 32, ff 512, 100 classes; ``VIT_DB``: 3 blocks of 4), fp32,
     ``GaussianMixtureImages`` batches of 128 32x32x3 images (patch 4: 66
     tokens): one DB step per block (4 attention launches of each kind, no
     AdaLN kernel: the label token's ``cond_mask``) and one e2e step (12
     each), wall, device busy and peak memory; ``predict`` of the 128
     images in 8 Euler steps (32 attention forwards, 8 Euler) with its
     logits within 1e-3 of ``impl="ref"``'s, and ``predict_e2e`` (12);
     accuracy printed (untrained: sanity only); one fp32 DB step on block
     0 through the kernels against ``impl="ref"`` within 1e-3;
 13. the masked-diffusion LM (paper §5.3) at full width (``MDM``: 12
     layers, d=768, 12 heads of 64, ff 3072, vocab 32 with [MASK] = 31;
     ``MDM_DB``: 3 blocks), fp32, ``MarkovLM`` batches of 64 x 256: one DB
     step per block (4 attention launches of each kind, 8 gate-residual
     forward and backward) and one e2e step (12, 24); ``nelbo_bpc`` with 2
     samples; ``generate`` of 8 x 256 in 50 steps and the final fill (51
     forwards of a 4-layer block: 204 attention and 408 gate-residual
     forwards); one fp32 DB step on block 0 through the kernels against
     ``impl="ref"`` within 1e-3;
 14. the fault-tolerant training system. 14a: stablelm-1.6b at full width
     and depth again (``DEFAULT_DB``: 4 blocks of 6 layers, random weights
     from seed 0, AdaLN heads randomised) through the round-robin
     ``BlockParallelTrainer``, bf16 policy with fp32 masters,
     replicate+psum-mean, ``MarkovStream`` batches of 8 x 512 through
     ``HostDataLoader``: a warm-up batch, a timed batch (wall, CUDA-event
     ms, peak memory beside phase 6's ``train_db`` and e2e peaks), a
     profiled batch (device-busy share), and a batch with a NaN injected
     into block 2's loss, whose stack, moments and step counter must stay
     bit-unchanged while the other blocks and the periphery move; each
     block update launches one DB step's kernels; then one fp32 batch at
     stablelm's widths with 4 layers (4 blocks of 1) through the kernels
     against ``impl="ref"`` (losses within 1e-3 relative, params within
     1e-3, first moments within 1e-3 of their largest). 14b:
     ``TrainRunner`` on stablelm's layer cut to 4 layers at half its width
     and a 32000-token vocabulary (``RUNNER_CUT``: 1.7 GB a generation
     where the full width took about 7), bf16, checkpoints in a
     temporary directory on the machine's disk
     (bytes, seconds and sha256 seconds of each save and load printed;
     deleted at the end): block-parallel (4 blocks of 1, 6 batches,
     checkpoints every 2, 2 kept) under ``RUNNER_FAULTS`` (a NaN block,
     a pod death and re-adoption, a torn generation) with its counters
     equal to ``RUNNER_COUNTERS``; the same run killed after batch 5 and
     resumed, which must fall back past the torn generation and end
     bit-equal to the uninterrupted run (params, moments, step counters,
     history, heartbeats, guard state); and db mode (2 blocks of 2
     layers) with one ``pod_die`` restart, killed after step 3 of 4.
     14c: the pod-per-block engine (``BlockParallelTrainer`` in its
     ``shard_map`` mode): ``MESH_RANKS`` ranks of this script
     (``--mesh-rank``), each on the one card under gloo (NCCL refuses two
     ranks on one device), meeting on a ``file://`` store, each loading
     the kernels phase 2 built (rank 0 first). First, in this process, the
     round-robin engine and runner on the same models, batches and draws
     (seeded alike). Then the ranks: (a) stablelm-1.6b at full width cut
     to 8 of its 24 layers in 4 blocks of 2, bf16, ``MarkovStream`` 4 x
     512: a warm-up batch, two timed batches (rank 0's wall, each rank's
     all-reduce ms and peak memory), a NaN in block 2's loss (its stack,
     moments and counter bit-unchanged on its rank, every other block
     moved); each rank's launches one DB step's a batch; (b)
     ``TrainRunner`` at ``MESH_RUNNER_CUT`` (4 layers in 4 blocks): one
     generation, a pod death, two orphan passes on rank 0, a re-adoption,
     counters ``MESH_RUNNER_COUNTERS`` and the launches of 16 block
     updates over the ranks; (c) fp32 at 4 layers (4 blocks of 1) through
     the kernels, one step against the round-robin engine on rank 0:
     losses and every param within 1e-5 relative. After every batch the
     periphery's bits equal on every rank; every batch's losses (and the
     runner's history) within 1e-3 relative of the round robin's. Any
     rank's failure, or the group outliving ``MESH_WALL_S``, fails the
     phase;
 15. the VLM (fatal if more than 1 GiB is still allocated at its
     start): llama-3.2-vision-11b at full width (40 layers: 8 superblocks
     of 4 self layers and one tanh-gated cross-attention layer; d=4096,
     32 heads of 128 on 8 KV heads; 1601 image tokens), ``DEFAULT_DB`` (4
     blocks of 2 superblocks), random fp32 weights from seed 0 with the
     AdaLN heads randomised and the cross gates opened (tanh(2)), bf16
     serving; a registry of 3 images (1601, 4096) fp32 from seed 1.
     ``cross_attend`` (plain torch) timed at the step's shapes and
     profiled; the static engine over 8 requests each with an image
     (prompts as phase 4's, 32 new tokens; wall, TTFT, ms a step, the
     bound from the shapes; launches 2 x 32 paged decodes and 2 x 40
     gate-residuals a step, 32 prefills a chunk) and again without images
     under the same draws (tokens must differ); ``ContinuousBatcher`` on 8
     slots (page 16, chunk 64, seg_len 16, prefix cache on, graphs): 32
     ``MarkovLM`` requests of 128-512 tokens, 64 new, 10 with an image
     (30%), three of them twins submitted once their originals' prompts
     are in the prefix cache (request 0's text under another image must
     share no page, request 3's text and image must share, request 0's
     text without an image shares none); every request complete, no page
     or image row leaked, launch counts equal to the dispatches'
     arithmetic, the first 4 segments graphed and eager identical (tokens,
     pages, image blocks); 4 conditioned requests one at a time through a
     one-slot ``pages`` router (1 prefill + 1 decode worker, one shared
     pool) bit-equal to a graphed batcher under the same draws; peak
     memory printed; then, the full model dropped, 2 superblocks (10
     layers) at full width in 2 blocks, fp32: 8 requests (5 with an
     image) for one segment through the kernels and through
     ``impl="ref"``, logits within 1e-3 relative, greedy tokens equal;
     memory allocated back within 0.5 GiB of the phase's start with no
     gc pass;
 16. the hybrid, after phase 15 and under the same memory checks:
     zamba2-7b at full width (81 Mamba2 layers in 27 units of 3, each
     followed by one application of the shared attention + MLP block;
     d=3584, 32 heads of 112, window 4096; 9.964 B params), ``DEFAULT_DB``
     (4 blocks), random fp32 weights from seed 0 with the AdaLN heads
     randomised, the bf16 policy (fp32 compute over the masters, bf16
     pages, fp32 Mamba rows): the static engine over 8 ``MarkovLM``
     requests (prompts padded to 512, ragged 128-512, 32 new; wall, TTFT,
     chunk and decode-step ms beside the bound from the shapes, 4 more
     steps profiled for the busy share); the graphed ``ContinuousBatcher``
     on 8 slots over 32 ``MarkovLM`` requests of 128-512 tokens, 32 new,
     draws keyed by prompt and position (tok/s, ms a segment step, chunk
     ms, TTFT, the share inside a dispatch, capture s); the first 8 again
     on it for 2 segments against an eager batcher (tokens, committed K/V
     and Mamba rows bit-equal), one of them then spilled mid-decode
     through ``SpilledSlot.to_bytes``/``from_bytes`` and restored, all 8
     finishing with the first run's tokens; request 8 (the first in a
     recycled slot) alone through the static engine, the same tokens;
     peak memory; then, the model dropped, 2 units at full width in 2
     blocks, fp32: one 4160-token prompt (the window bites) and 8 new
     tokens through the kernels and through ``impl="ref"``, logits within
     1e-3 relative, tokens equal; memory back within 0.5 GiB with no gc
     pass;
 17. the hybrid's training, after phase 16 and under its memory check:
     zamba2-7b at full width cut to 8 units (24 Mamba2 layers, 8
     applications of the shared block; 3.322 B params) in 4 blocks of 2
     units, random fp32 weights from seed 0 with the AdaLN heads
     randomised, the bf16 policy (fp32 compute for the family): every
     block's AdamW state made up front (as ``train_db`` keeps them), a
     warm-up DB step, one DB step of each block at 4 x 512 ``MarkovLM``
     tokens (two-pass: the noisy stream through ``mamba2_two_pass`` and
     the shared block's two_pass attention; wall, device ms, peak,
     launches against the path's arithmetic, only the block's units and
     the rest changed), one under the profiler (busy share); then one AdamW
     state over every param and the end-to-end step at 2 x 512 (warm-up,
     timed, profiled); then, the model dropped, 2 units at full width in
     one block, fp32: one DB step through the kernels against
     ``impl="ref"`` within 1e-3 on the loss, the grad norm and the moments
     of the block's leaves; memory back within 1 GiB of the phase's start;
 18. h2o-danube3-4b, after phase 17 and under its memory check: full width
     (24 layers, d=3840, 32 query heads on 8 KV heads of 120, ff 10240,
     window 4096; 6.101 B params with the AdaLN heads), ``DEFAULT_DB``,
     random fp32 weights from seed 0 with the AdaLN heads randomised, bf16
     policy. Served at full depth: phase 5b's queue (32 requests on 8
     slots, 64 new tokens, CUDA-graph segments and chunk steps; tok/s, ms
     a segment step, peak; every request complete, no page leaked, launches
     equal to the dispatches' arithmetic; with the batcher and serving
     copies dropped at most 1 GiB beyond the masters and no batcher left).
     Trained cut to 12 layers (3.182 B params: at 24 the masters and four
     AdamW states take 79.5 GB, the e2e step's masters, grads, moments and
     bf16 copy 110 GB) in 4 blocks of 3, ``MarkovLM`` batches of 8 x 512:
     every block's AdamW state made up front, a warm-up and one concat x
     CE DB step on each block, one profiled; a two_pass x l2 DB step of
     block 0 (warm-up, timed, profiled); the e2e step (warm-up, timed,
     profiled); each step's wall, device ms, peak, busy share, finite loss
     and grad norm, launches equal to the path's arithmetic; then, the
     model dropped, 2 layers at full width in one block, fp32: one DB
     step in concat x CE and one in two_pass x l2 through the kernels
     against ``impl="ref"`` within 1e-3; memory back within 1 GiB;
 19. whisper-small, after phase 18 and under its memory check: full width
     and depth (12 encoder and 12 decoder layers, d=768, 12 heads of 64,
     d_ff 3072, vocab 51865, 1500 audio frames, LayerNorm, gelu,
     sinusoidal positions; the encoder ``full`` and the decoder's
     cross-attention over its memory through the attention kernels),
     ``DEFAULT_DB`` (4 blocks of 3 decoder layers), random fp32 weights
     from seed 0 with the AdaLN heads randomised. Served, bf16: the static
     engine over 8 requests each with (1500, 768) fp32 audio from a seeded
     generator (prompts up to 64 tokens, 32 new; then without audio: the
     tokens must differ); phase 5b's graphed batcher over 32 requests on 8
     slots, every one with audio of 600-1500 frames encoded alone at its
     admission, the even ones behind one 256-token prefix with one shared
     audio, prompts of 128-384 tokens and 64 new (whisper's 448-token
     text context): tok/s, the segment step against its bound, the
     encoder's ms per admission, peak; one audio request through a
     one-slot ``pages`` router bit-equal to a graphed batcher under the
     same draws; greedy fp32 decoding of 8 audio requests for one segment
     through the kernels and through ``impl="ref"``, tokens identical and
     logits within 1e-3; serving must leave at most 1 GiB beyond the
     masters and no batcher. Trained, bf16 policy with bf16 audio,
     ``MarkovLM`` batches of 8 x 448 with 8 x 1500 frames: a concat x CE
     DB step on each block with all four AdamW states resident (the
     encoder forward and backward in each), a two_pass x l2 step of block
     0 (the EDM-loss kernels at d 768), the e2e step; wall, device ms,
     busy share, peak, finite loss and grad norm, launches equal to the
     path's arithmetic (the encoder's calls included); then 2 encoder + 2
     decoder layers, fp32: a DB step in concat x CE and in two_pass x l2
     through the kernels against ``impl="ref"`` within 1e-3; memory back
     within 1 GiB;
 20. llama-3.2-vision-11b's training, after phase 19 and under its memory
     check: full width cut to one superblock (4 self layers and the cross
     layer; 2.663 B params: two superblocks' masters, two blocks' AdamW
     states, one block's gradients and the bf16 copy would take 76.7 GB)
     in one block, the cross gates opened, bf16 policy, ``MarkovLM``
     batches of 4 x 512 over 4 x 1601 bf16 image tokens from the seeded
     generator: a concat x CE DB step (its AdamW state made first), a
     two_pass x l2 DB step, the e2e step (each warm-up, timed, profiled;
     wall, device ms, busy share, peak, finite loss and grad norm,
     launches equal to the path's arithmetic); then, the model dropped,
     one self and one cross layer at full width, fp32: a DB step in
     concat x CE and in two_pass x l2 through the kernels against
     ``impl="ref"`` within 1e-3 (the cross layer's ``wk``, ``wv`` and
     ``xgate`` among the moments); memory back within 1 GiB; the byte
     reckoning printed before anything is made;
 21. phi3.5-moe-42b-a6.6b, after phase 20 and under its memory check: full
     width (d 4096, 32 query heads on 8 KV heads of 128, 16 experts of
     d_ff 6400, top 2, capacity factor 1.25), random fp32 weights from
     seed 0 with the AdaLN heads randomised, bf16 policy. Served cut to 6
     layers (8.687 B params; fp32 masters and bf16 copy 48.0 GiB): the
     static engine over 8 requests (prompts to 512, 32 new), phase 5b's
     queue through the graphed batcher (every request complete, no page
     leaked, launches equal to the dispatches' arithmetic, at most 1 GiB
     left beyond the masters), 8 requests for one segment at 2 layers,
     fp32, through the kernels and ``impl="ref"``: tokens identical,
     logits within 1e-3. Trained cut to 2 layers in 2 blocks, 4 x 512:
     a concat x CE DB step on each block with both AdamW states
     resident, a two_pass x l2 DB step, the e2e step, each with its router
     aux loss; the share of the routers' picks dropped for capacity in
     one DB forward a block; then 1 layer, fp32: concat and two_pass
     through the kernels against ``impl="ref"`` within 1e-3 (the router's
     and the experts' moments among them); memory back within 1 GiB.
 22. xlstm-125m, after phase 21 and under its memory check: full width
     and depth (12 layers: 6 units of one sLSTM and one mLSTM block, d
     768, 4 heads; 0.1915 B params served as their fp32 masters; 14.23 MB
     of fp32 state a slot, no pages) in 3 blocks, random weights from seed
     0 with the AdaLN heads randomised, bf16 policy (the family computes
     and keeps its state in fp32). The static engine over 8 requests
     (prompts to 512, chunk 64, 32 new; its device busy share over 4 more
     decode steps); phase 5b's queue through the graphed batcher with draws
     keyed by prompt and position (every request complete, no page leaked,
     the chunk step a chain of per-token steps in one graph), the first 8
     prompts again in recycled slots with one spilled mid-decode through
     the wire bytes and restored, then 4 of them at once over HTTP/SSE
     through ``InferenceServer`` on the same batcher: all with the first
     run's tokens; a one-slot check (the same second request after two
     other first occupants, the same tokens); the prefix cache and a
     ``SharedPagePool`` refusing the family; 8 prompts at full depth, fp32,
     through the kernels and ``impl="ref"``: tokens identical, logits
     within 1e-3; launches equal to the path's arithmetic (a gate-residual
     a block in the probes, none in the commit or the chunk); memory back
     within 1 GiB.
 23. xlstm-125m's training, after phase 22 and under its memory check: the
     same model (full width and depth, 3 blocks of 2 units), bf16 policy,
     ``MarkovLM`` batches; ``block_loss`` takes the two-pass route for the
     family (the sLSTM an eager scan over time, the mLSTM's parallel form
     and its strict-history query). A two_pass x CE DB step on each block
     at 8 x 512 with all three AdamW states resident, one at 4 x 1024
     (the clean mLSTM in its chunked form), a two_pass x l2 step (the
     EDM-loss kernels), the e2e step at 8 x 512 (no σ: no kernel); each
     step's wall beside its bound from the shapes (6 N D over the units
     and both streams, the readout's CE, the mLSTM's quadratic terms, at
     the fp32 peak), busy share and top kernels under the profiler, peak
     memory, finite loss and grad norm, launches equal to the path's
     arithmetic (two gate-residual calls a unit, forward and backward, in
     a DB step; none in e2e); then one fp32 DB step of block 0 through the
     kernels against ``impl="ref"``, every trained leaf's moment within
     1e-4; memory back within 1 GiB.
 24. the dense-cache serving path (``init_cache``, ``prefill``,
     ``prefill_probe``, ``serve_step``; the flash-decode kernel over the
     dense cache viewed as one page of C keys a slot), after phase 23 under
     its memory check. (a) stablelm-1.6b at full width and depth, bf16
     policy, the kernels: ``prefill`` of 8 x 512 (a flash-attention
     forward a layer), ``prefill_probe(k=1)`` (its unit 0 the prefill's);
     128 tokens committed one at a time into ``init_cache(8, 160)``, the
     caches against the prefill of the same 128 tokens (worst leaf within
     5e-2 relative); 32 greedy ``serve_step``s; the prefill's and a step's
     ms beside their bounds from the shapes, busy shares, top kernels and
     the peak; then fp32: the same commits within 2e-3 of the fp32 prefill
     (JAX's bound), 16 greedy dense steps through the kernels and through
     ``impl="ref"`` (logits within 1e-3) and through the paged static
     engine on the same z: identical tokens. (b) xlstm-125m at full width
     and depth, fp32: the dense ``prefill`` of 8 x 512 (the sequence
     forms) against the paged chunk chain (per-token steps), every state
     leaf within 1e-4 relative, both walls; 16 greedy dense steps from the
     prefill's state and the paged engine's from the chain's: identical
     tokens. (c) ``decode_attention`` on a 4096-slot ring at
     h2o-danube3-4b's attention dims (32 heads on 8 of 120), 8 slots, wo
     the identity: the kernel route against the reference route at
     positions 100, 4095, 4096 and 9000, bf16 and fp32, within the
     kernel's tolerance, the ring bit-unchanged. Then the flash-decode
     kernel over the identity view at (a)'s probe (fp32 q over a bf16
     cache of 160 slots at 144 keys) and (c)'s bf16 ring (4095 keys)
     against its plain version, timed: cases of the kernels line. Every
     run's launches equal to its arithmetic; memory back within 1 GiB.

Prints one JSON line ``{"kernels": [...]}`` and, last, ``{"ok": true,
"device": {...}}``. The Euler backward runs on no main path (the samplers
run under ``no_grad``): it is checked in phase 3 only and reports 0
launches. Exits non-zero without a CUDA device or without the
repository's ``src`` beside it.
"""
import dataclasses
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
import weakref
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "build" / "chip_smoke"      # full -Xptxas -v logs
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_BF16 = 989e12             # dense tensor-core bf16
PEAK_FP32 = 67e12              # fp32 outside the tensor cores
# fp32-accurate products on the tensor cores: three tf32 products each
# (3xTF32) at the dense tf32 rate. The fp32 attention bounds take the larger
# of this and PEAK_FP32, the least time for the work whatever kernel does it
PEAK_FP32_TC = 494.7e12 / 3
TOL = 2e-4
BF16_ULP = 2.0 ** -7           # one rounding of a bf16 output, relative
ARCH = "stablelm-1.6b"
TWO_PASS_ARCH = "olmo-1b"
BATCH, PROMPT, CHUNK, MAX_NEW, PSZ = 8, 512, 64, 32, 16
TRAIN_BATCH, TRAIN_SEQ = 8, 512
ATTN = ("flash_attention_fwd", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkv")
DIT_TOKENS, DIT_DIM, DIT_BATCH = 256, 16, 256   # DiT-S/2: 32x32x4, patch 2
DIT_SAMPLES, DIT_STEPS = 256, 18
VIT_BATCH, VIT_STEPS = 128, 8                   # predict as Table 1 calls it
MDM_BATCH, MDM_SEQ, MDM_GEN = 64, 256, 8        # 256: MD4's text8 context
HUGINN_BPTT = 8
TC_KERNELS = ("fwd_tc_kernel", "fwd_tf32_kernel", "dq_tc_kernel",
              "dkv_tc_kernel", "dq_tf32_kernel", "dkv_tf32_kernel")
PAGED_KERNELS = ("paged_decode_kernel", "prefill_tc_kernel",
                 "prefill_tf32_kernel")
# kernel ms that PERF.md records for the kernels the paged redesigns
# replaced (NVIDIA H100 80GB HBM3, 700.00 W): decode (a), prefill (c) in
# bf16, and (c) with fp32 q and pages (the CUDA-core
# paged_attention_kernel); printed beside this run's times, never measured
# here
PRIOR_DECODE_A_MS, PRIOR_PREFILL_C_MS = 0.0548, 0.3148
PRIOR_PREFILL_C_FP32_MS = 0.2593
# the bf16 serve cross-check (phase 5): prompts and z of each seed, and the
# limits set from its readings (PERF.md): the whole path's logits, and the
# pages the tensor-core prefill reaches, above every sound seed and below
# the bf16-P control
BF16_CROSS_SEEDS = (0, 1, 2)
BF16_LOGITS_LIMIT, BF16_PAGES_LIMIT = 4.5e-5, 1.5e-3
# the continuous phase (5b): traffic and its graph-against-eager window
CB_SLOTS, CB_REQUESTS, CB_NEW, CB_SEG = 8, 32, 64, 16
CB_MIN, CB_MAX, CB_SHARED, CB_CHECK_SEGMENTS = 128, 512, 256, 4
# the serving system (5c): each trace's requests, prompt median, new tokens
# (median 32), arrival rates as shares of the requests/s phase 5b finished,
# trace B's mean burst, the class mix and the interactive SLOs; the memory
# the dropped servers may leave allocated
SRV_REQUESTS, SRV_PROMPT, SRV_NEW = 48, 256, (16, 64)
SRV_RATE_A, SRV_RATE_B, SRV_BURST = 0.6, 1.5, 4
SRV_MIX = (("interactive", 0.2), ("standard", 0.6), ("batch", 0.2))
SRV_TTFT_SLO_MS, SRV_TPOT_SLO_MS = 2000, 100
SRV_HOST, SRV_MEM_SLACK = "127.0.0.1", 0.5 * 2**30
# disaggregated serving (5d): decode workers beside the one prefill worker;
# the fault run's restart delay of the killed decode0, its handoff
# drop and stall (the router's send count) and the stall's excess over the
# handoff timeout; the full-width copy run's requests; the memory the
# dropped routers may leave allocated
DG_DECODE, DG_RESTART_S = 2, 1.0
DG_DROP_AT, DG_STALL_AT, DG_STALL_OVER_S = 3, 6, 0.1
DG_COPY_REQUESTS, DG_MEM_SLACK = 4, 0.1 * 2**30
# the VLM (15): the arch, its cross gates (opened: tanh(2) = 0.96), the
# image registry (JAX's --cond-pool 3), the conditioned requests of the
# continuous queue (30%: JAX's cond_frac in table18_load) and its three
# twins (see vlm_queue), the migrated requests and their new tokens, the
# layers of a superblock (the fp32 check keeps 2), and the memory the
# phase may find allocated at its start and leave behind
VLM_ARCH, VLM_XGATE, VLM_POOL = "llama-3.2-vision-11b", 2.0, 3
VLM_COND = (0, 3, 6, 10, 13, 16, 20, 23)
VLM_TWINS = ("other image", "same image", "no image")
VLM_MIGRATE, VLM_MIGRATE_NEW, VLM_CUT_EVERY = 4, 32, 5
VLM_MEM_START, VLM_MEM_SLACK = 2**30, 0.5 * 2**30
# the hybrid (16): the arch, the new tokens of its static and continuous
# runs, the fp32 check's depth cut (units of 3 Mamba layers and the shared
# block), prompt (past the 4096-token window) and decode steps, and the
# memory the phase may find allocated at its start and leave behind
HYB_ARCH, HYB_NEW, HYB_CHECK_SEGMENTS = "zamba2-7b", 32, 2
HYB_CUT_UNITS, HYB_LONG, HYB_LONG_NEW = 2, 4160, 8
HYB_MEM_START, HYB_MEM_SLACK = 2**30, 0.5 * 2**30
# the hybrid's training (17): the depth cut in whole units (the fp32
# masters, every block's AdamW state and one block's gradients must fit one
# card: at full depth the masters alone are 39.86 GB), its blocks, the DB
# and e2e batches (x TRAIN_SEQ tokens), the depth of the kernels-vs-plain
# check, and the memory the phase may leave behind
HYB_TRAIN_UNITS, HYB_TRAIN_BLOCKS = 8, 4
HYB_DB_BATCH, HYB_E2E_BATCH, HYB_CHECK_UNITS = 4, 2, 2
HYB_TRAIN_SLACK = 2**30
# h2o-danube3-4b (18): the arch; the training depth cut (at 24 layers its
# 6.10 B params take 24.4 GB of fp32 masters, its four AdamW states 55.1
# GB more, and the e2e step's masters, grads, moments and bf16 copy 110 GB:
# neither fits one card); the depth of the fp32 kernels-vs-plain checks;
# the memory the phase may find allocated at its start, and the memory
# beyond the masters that serving may leave behind
H2O_ARCH, H2O_TRAIN_LAYERS, H2O_CHECK_LAYERS = "h2o-danube-3-4b", 12, 2
H2O_MEM_START, H2O_SERVE_SLACK = 2**30, 2**30
# whisper-small (19): the arch; the static engine's prompts (ragged, up to
# 64 tokens) and the batcher's (CB_MIN-384 tokens, so that a prompt and its
# CB_NEW tokens stay within whisper's 448-token text context,
# arXiv:2212.04356), the frames of the batcher's ragged audio, the training
# sequence (that text context) and the depth of the fp32 check (encoder and
# decoder layers each); the memory the phase may find allocated at its
# start
W_ARCH, W_PROMPT, W_CB_MAX, W_FRAMES = "whisper-small", 64, 384, (600, 1500)
W_TRAIN_SEQ, W_CHECK_LAYERS, W_MEM_START = 448, 2, 2**30
# llama-3.2-vision-11b's training (20): the depth cut, one superblock in
# one block (2.66 B params; two superblocks in 2 blocks, 4.26 B, take 76.7
# GB of masters, AdamW moments, gradients and bf16 copy before any
# activation), and the batch of its steps and of phase 21's training
VLM_TRAIN_LAYERS, VLM_TRAIN_BATCH = 5, 4
# phi3.5-moe-42b-a6.6b (21): the arch; the serving cut, the largest even
# depth whose fp32 masters and bf16 copy fit in about 60 GiB (6 layers:
# 48.0 GiB; 8: 63.7); the fp32 greedy check's depth; the training cut (2
# layers as 2 blocks, both AdamW states resident) and the fp32 check's
MOE_ARCH, MOE_SERVE_LAYERS, MOE_CHECK_SERVE_LAYERS = (
    "phi3.5-moe-42b-a6.6b", 6, 2)
MOE_TRAIN_LAYERS, MOE_CHECK_LAYERS = 2, 1
# the memory phases 20 to 22 may find allocated at their start
PHASE_MEM_START = 2**30
# xlstm-125m (22): the arch and its blocks (6 units in 3 of 2, as JAX's
# default DBConfig cuts it); the slot-reuse check's prompts (one chunk
# each) and new tokens, the requests sent over HTTP at once, and the fp32
# check's prompts and new tokens
XL_ARCH, XL_BLOCKS = "xlstm-125m", 3
XL_REUSE_LEN, XL_REUSE_NEW, XL_HTTP_REQUESTS = 16, 8, 4
XL_CHECK_PROMPT, XL_CHECK_NEW = 64, 8
# its training (23): the long DB step's batch and length (past 512 the
# clean mLSTM takes its chunked form)
XL_LONG_BATCH, XL_LONG_SEQ = 4, 1024


class SmokeError(RuntimeError):
    pass


def say(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------

def gpu_query(fields: str) -> str:
    res = subprocess.run(["nvidia-smi", f"--query-gpu={fields}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def phase_device() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_query("name,power.limit")
    say(f"[device] {card}")
    say(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} | {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()} | tf32 off")


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------

def ptxas_summary(entry: str) -> str:
    """One instantiation's ``-Xptxas -v`` entry as one line: its mangled
    name, registers, shared memory, spills."""
    name = re.search(r"Compiling entry function '(\S+)'", entry)
    regs = re.search(r"Used (\d+) registers", entry)
    smem = re.search(r"(\d+) bytes smem", entry)
    spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      entry)
    return (f"{name.group(1) if name else '?'}: "
            f"{regs.group(1) if regs else '?'} registers, "
            f"{smem.group(1) if smem else 0} B static smem, spills "
            f"{spill.groups() if spill else (0, 0)}")


def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    built = _build.build()
    say(f"[build] {len(built)} kernel libraries built in "
        f"{time.perf_counter() - t0:.1f} s into {_build.build_dir()}")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    for name, info in built.items():
        log = info["log"]
        (OUT_DIR / f"ptxas_{name}.log").write_text(log)
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        smem = [int(b) for b in re.findall(r"(\d+) bytes smem", log)]
        spills = [line.strip() for line in log.splitlines()
                  if "spill stores" in line
                  and "0 bytes spill stores, 0 bytes spill loads" not in line]
        say(f"[build] {name}: {info['seconds']:.1f} s, {len(regs)} kernels, "
            f"registers max {max(regs, default=0)}, smem max "
            f"{max(smem, default=0)} B, kernels that spill: {len(spills)}")
        for line in spills[:4]:
            say(f"[build]   {line}")
        # the attention kernels on the tensor cores, line by line; the
        # paged kernels, a line an instantiation
        for entry in re.split(r"(?=ptxas info\s*: Compiling entry)", log):
            if any(k in entry for k in TC_KERNELS):
                for line in entry.splitlines():
                    if "Compile time" not in line:
                        say(f"[build]   {line.strip()}")
            elif any(k in entry for k in PAGED_KERNELS):
                say(f"[build]   {ptxas_summary(entry)}")
    for name in _build.SOURCES:
        _build.load(name)


# ---------------------------------------------------------------------------
# 3. kernels against their plain versions
# ---------------------------------------------------------------------------

def eager_ms(fn, n_inputs: int, iters: int = 40) -> float:
    """ms per eager call of fn(i), CUDA events around a loop: what the
    serving path pays per launch, host overhead (Python, wrapper checks,
    ctypes) included when the host is the slower side."""
    for i in range(3):
        fn(i % n_inputs)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i % n_inputs)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_trials(fn, n_inputs: int, calls: int = 16, reps: int = 10,
                  trials: int = 1) -> list:
    """Device ms per call of fn(i), ``trials`` readings: ``calls`` calls
    captured in one CUDA graph, replayed ``reps`` times between CUDA events
    per reading, so no host time is counted. Inputs cycle over n_inputs
    copies that together exceed the 50 MB L2, so each call finds its pages
    cold, as on the serving path."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i % n_inputs)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(i % n_inputs)
    graph.replay()
    torch.cuda.synchronize()
    readings = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        readings.append(start.elapsed_time(end) / (reps * calls))
    return readings


def device_ms(fn, n_inputs: int, calls: int = 16, reps: int = 10) -> float:
    return device_trials(fn, n_inputs, calls, reps)[0]


def compare(name: str, got, want, bf16_rounding: bool = False) -> float:
    """Max |err|; raises past TOL + TOL |ref|, or, for bf16 outputs with
    ``bf16_rounding``, past TOL + 2^-7 |ref| (one rounding of the output:
    the kernel and the plain version accumulate in fp32 in another order,
    which moves a value across a bf16 rounding boundary now and then)."""
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    worst = 0.0
    for g, w in zip(got, want):
        rel = BF16_ULP if bf16_rounding and g.dtype == torch.bfloat16 \
            else TOL
        g, w = g.float(), w.float()
        if not torch.isfinite(g).all():
            raise SmokeError(f"{name}: kernel output is not finite")
        err = (g - w).abs()
        worst = max(worst, err.max().item())
        if (err > TOL + rel * w.abs()).any():
            raise SmokeError(f"{name}: kernel disagrees with its plain "
                             f"version, max |err| {err.max().item():.3e}")
    return worst


def rotations(nbytes: int) -> int:
    return max(2, math.ceil(3 * 50e6 / max(nbytes, 1)) + 1)


def attn_work(q, pages, lengths, npg, window, prefill, quantized):
    """(bytes, flops, peak) the call needs with this run's lengths: q read,
    each key row some query can see read once as K and V (plus its page's
    scales), table and lengths read, out (and lse) written; flops count the
    (row, key) pairs the masks admit, 2 for q.k and 2 for p.v per dim."""
    B, KV, hd, psz = q.shape[0], pages.shape[2], pages.shape[3], \
        pages.shape[1]
    C = q.shape[1] if prefill else 1
    G = q.shape[-2]
    L = npg * psz
    keys, pairs, pages_read = 0, 0, 0
    for n in lengths.tolist():
        q_first, q_last = (n, n + C - 1) if prefill else (n, n)
        kend = min(q_last + 1 if prefill else n, L)
        kbeg = max(0, q_first - window + 1) if window else 0
        keys += max(0, kend - kbeg)
        pages_read += max(0, -(-kend // psz) - kbeg // psz)
        for i in range(C):
            qpos = n + i if prefill else n
            hi = min(qpos + 1 if prefill else qpos, L)
            lo = max(0, qpos - window + 1) if window else 0
            pairs += max(0, hi - lo)
    nbytes = (q.numel() * q.element_size()
              + keys * KV * hd * pages.element_size() * 2
              + (pages_read * 8 if quantized else 0)
              + B * npg * 4 + B * 4 + B * C * KV * G * hd * 4
              + (0 if prefill else B * KV * G * 4))
    flops = pairs * KV * G * hd * 4
    # fp32 q: the fp32 rate the card reaches, on the tensor cores by 3xTF32
    peak = PEAK_BF16 if q.dtype == torch.bfloat16 else max(PEAK_FP32,
                                                           PEAK_FP32_TC)
    return nbytes, flops, peak


def bound(nbytes: float, flops: float, peak: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def make_pool(gen, dtype, P, KV, hd, dev):
    shape = (P, PSZ, KV, hd)
    if dtype == torch.int8:
        k = torch.randint(-127, 128, shape, generator=gen, device=dev,
                          dtype=torch.int8)
        v = torch.randint(-127, 128, shape, generator=gen, device=dev,
                          dtype=torch.int8)
        ks = torch.rand(P, generator=gen, device=dev) * 0.02 + 1e-3
        vs = torch.rand(P, generator=gen, device=dev) * 0.02 + 1e-3
        return k, v, ks, vs
    k = torch.randn(shape, generator=gen, device=dev).to(dtype)
    v = torch.randn(shape, generator=gen, device=dev).to(dtype)
    return k, v, None, None


def paged_case(label, kind, *, KV, G, hd, page_dtype, q_dtype, window,
               lengths, dev, gen, C=1, prior=None, cap=PROMPT + MAX_NEW):
    """One paged kernel case against its plain version, timed by CUDA-graph
    replay: one slot a length, each with pages for ``cap`` keys; ``prior``:
    the ms PERF.md records for the kernel this one replaced at the same
    case, printed beside this run's (not measured here, so kept out of the
    row)."""
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.kernels import flash_prefill as FP
    B = len(lengths)
    npg = -(-cap // PSZ)
    P = 1 + B * npg
    prefill = kind == "flash_prefill"
    kern, ref = ((FP.flash_prefill, FP.flash_prefill_ref) if prefill
                 else (FD.flash_decode, FD.flash_decode_ref))
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    table = (1 + torch.randperm(B * npg, generator=gen, device=dev)
             ).to(torch.int32).reshape(B, npg)
    qshape = (B, C, KV, G, hd) if prefill else (B, KV, G, hd)
    one = make_pool(gen, page_dtype, P, KV, hd, dev)
    pool_bytes = sum(t.numel() * t.element_size() for t in one
                     if t is not None)
    sets = [one] + [make_pool(gen, page_dtype, P, KV, hd, dev)
                    for _ in range(rotations(pool_bytes) - 1)]
    q = torch.randn(qshape, generator=gen, device=dev).to(q_dtype)
    kw = lambda s: dict(window=window, k_scale=s[2], v_scale=s[3])
    got = kern(q, sets[0][0], sets[0][1], table, lens, **kw(sets[0]))
    torch.cuda.synchronize()
    want = ref(q, sets[0][0], sets[0][1], table, lens, **kw(sets[0]))
    err = compare(label, got, want)
    call_k = lambda i: kern(q, sets[i][0], sets[i][1], table, lens,
                            **kw(sets[i]))
    call_r = lambda i: ref(q, sets[i][0], sets[i][1], table, lens,
                           **kw(sets[i]))
    ms, e_ms = device_ms(call_k, len(sets)), eager_ms(call_k, len(sets))
    plain_ms = device_ms(call_r, len(sets), calls=4, reps=3)
    nbytes, flops, peak = attn_work(q, one[0], lens, npg, window, prefill,
                                    page_dtype == torch.int8)
    bound_ms, by = bound(nbytes, flops, peak)
    row = {"case": label, "max_abs_err": err, "ms": ms, "eager_ms": e_ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
           "library_ms": None, "bytes": nbytes, "flops": flops}
    if prefill:
        route = {"tc": "prefill_tc_kernel", "tf32": "prefill_tf32_kernel"
                 }[FP.prefill_route(q_dtype, page_dtype)]
    else:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        ns = FD.decode_splits(B * KV, FD.max_tiles(npg * PSZ, window), sms)
        route = f"paged_decode_kernel, {ns} blocks a pair"
    say(f"[kernels] {label} [{route}]: max|err| {err:.2e} | kernel {ms:.4f} "
        f"ms device ({e_ms:.4f} ms per eager call) | bound {bound_ms:.4f} ms "
        f"({by}; {nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP) | plain "
        f"{plain_ms:.3f} ms | library none")
    if prior is not None:
        say(f"[kernels] {label}: {ms:.4f} ms this run; the kernel it "
            f"replaced {prior:.4f} ms (recorded in PERF.md, NVIDIA H100 80GB "
            "HBM3, 700.00 W; not this run)")
    return row


def gate_case(label, shape, x_dtype, gate_dtype, dev, gen, prior=None):
    """The gate-residual forward on a strided (B, 6d) head slice; ``prior``:
    its predecessor's ms as PERF.md records it, printed beside this run's
    (not measured here, so kept out of the row)."""
    from repro_torch.kernels import fused_adaln as AD
    B, S, d = shape
    res = torch.randn(shape, generator=gen, device=dev).to(x_dtype)
    br = torch.randn(shape, generator=gen, device=dev).to(x_dtype)
    heads = (0.1 * torch.randn(B, 6 * d, generator=gen, device=dev)
             ).to(gate_dtype)
    gate = heads[:, 2 * d:3 * d]            # the probe's strided slice
    got = AD.gate_residual(res, br, gate)
    torch.cuda.synchronize()
    err = compare(label, got, AD.gate_residual_ref(res, br, gate))
    call_k = lambda i: AD.gate_residual(res, br, gate)
    g1 = 1.0 + gate[:, None, :].to(x_dtype)
    call_l = lambda i: torch.addcmul(res, br, g1)
    # a launch lasts about a microsecond at the probe's shape, where one
    # reading of kernel and library each swings by ~10%: median of three
    ms = statistics.median(device_trials(call_k, 1, calls=64, trials=3))
    library_ms = statistics.median(device_trials(call_l, 1, calls=64,
                                                 trials=3))
    e_ms = eager_ms(call_k, 1, iters=200)
    plain_ms = device_ms(lambda i: AD.gate_residual_ref(res, br, gate), 1,
                         calls=64)
    nbytes = 3 * res.numel() * res.element_size() + B * d * \
        gate.element_size()
    flops = 2 * res.numel()
    bound_ms, by = bound(nbytes, flops, PEAK_FP32)
    say(f"[kernels] {label}: max|err| {err:.2e} | kernel {ms:.5f} ms device "
        f"({e_ms:.4f} ms per eager call) | bound {bound_ms:.5f} ms ({by}; "
        f"{nbytes / 1e6:.3f} MB) | plain {plain_ms:.5f} ms | library "
        f"(addcmul, 1+gate made outside) {library_ms:.5f} ms")
    if prior is not None:
        say(f"[kernels] {label}: {ms:.5f} ms this run; the grid-stride "
            f"kernel it replaced {prior:.4f} ms (recorded in PERF.md, NVIDIA "
            "H100 80GB HBM3, 700.00 W; not this run)")
    return {"case": label, "max_abs_err": err, "ms": ms, "eager_ms": e_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
            "library_ms": library_ms, "bytes": nbytes, "flops": flops}


def rowwise_case(label, kern, ref, sets, nbytes, flops, prior=None) -> dict:
    """One row-wise kernel (its wrapper, with any launch it makes) against
    its plain version on input set 0, then timed by CUDA-graph replay over the
    sets, which together exceed the 50 MB L2 (each call finds its inputs
    cold, as a layer of the training step does). No single PyTorch call
    computes these functions: F.layer_norm takes no per-example affine, and
    the loss needs its target formed first. ``prior``: the predecessor's ms
    at this case as PERF.md records it, printed beside this run's (not
    measured here, so kept out of the row)."""
    got = kern(*sets[0])
    torch.cuda.synchronize()
    err = compare(label, got, ref(*sets[0]), bf16_rounding=True)
    n = len(sets)
    ms = device_ms(lambda i: kern(*sets[i]), n)
    plain_ms = device_ms(lambda i: ref(*sets[i]), n, calls=4, reps=3)
    bound_ms, by = bound(nbytes, flops, PEAK_FP32)
    say(f"[kernels] {label}: max|err| {err:.2e} | kernel {ms:.4f} ms device "
        f"| bound {bound_ms:.4f} ms ({by}; {nbytes / 1e6:.1f} MB, "
        f"{flops / 1e9:.3f} GFLOP) | plain {plain_ms:.4f} ms | library none")
    if prior is not None:
        say(f"[kernels] {label}: {ms:.4f} ms this run; the kernel it "
            f"replaced {prior:.4f} ms (recorded in PERF.md, "
            "NVIDIA H100 80GB HBM3, 700.00 W; not this run)")
    return {"case": label, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
            "library_ms": None, "bytes": nbytes, "flops": flops}


def adaln_sets(gen, dev, B, S, d, dt):
    """(x, scale, shift, g) input sets for the AdaLN kernels, enough to
    exceed the L2 together: x off-centre, the (B, d) vectors fp32 column
    slices of one (B, 6d) head output (row stride 6d)."""
    one = 2 * B * S * d * torch.tensor([], dtype=dt).element_size()
    out = []
    for _ in range(rotations(one)):
        x = (1.0 + torch.randn(B, S, d, generator=gen, device=dev)).to(dt)
        g = torch.randn(B, S, d, generator=gen, device=dev).to(dt)
        heads = 0.1 * torch.randn(B, 6 * d, generator=gen, device=dev)
        out.append((x, heads[:, d:2 * d], heads[:, :d], g))
    return out


def adaln_plan(name, x, vec) -> str:
    """A redesigned AdaLN kernel's launch plan at these inputs."""
    from repro_torch.kernels import fused_adaln as AD
    B, S, d = x.shape
    p = AD.launch_plan(name, B, S, d, x.dtype, vec.dtype, x.device)
    tiles = (f"blocks ({p['cx']}, {p['ry']}) threads, {p['n_tiles']} tiles "
             f"of {p['tile_rows']} rows an example")
    if name == "ln_modulate_fwd":
        return tiles
    return (f"{tiles} in clusters of {p['cl']}, "
            f"{p['scratch'] * 4 / 1e6:.3f} MB scratch; the tiles are summed "
            "in the kernel (no partial-sum launch)")


# ms of the AdaLN backwards the redesign replaced, at phase 3's cases, from
# PR 20's chip_smoke.py run (NVIDIA H100 80GB HBM3, 700.00 W; recorded in
# PERF.md): printed beside this run's, never measured here
PRIOR_LN_BWD_MS = {"bf16": 0.0564, "fp32": 0.0755, "ragged": 0.0336}
# the warp-per-row ln-modulate forward the row-tile redesign replaced, at
# the main case (recorded in PERF.md, NVIDIA H100 80GB HBM3, 700.00 W; not
# measured here)
PRIOR_LN_FWD_MS = 0.0193
PRIOR_GATE_BWD_MS = {"bf16": 0.0318, "fp32": 0.0433, "ragged": 0.0207,
                     "dit": 0.1101}


def phase_rowwise(dev) -> dict:
    """The ln-modulate, gate-residual backward and EDM-loss kernels at the
    two-pass olmo-1b path's shapes (8 x 512 rows of d = 2048; the AdaLN
    vectors fp32 column slices of a (B, 6d) head output, row stride 6d),
    the first case of each being its main case; plus an fp32-stream case,
    a ragged one (S not a multiple of the kernels' tiles) and, for the
    gate backward and the loss, the DiT-S/2 step's (256, 256, 384) and
    (256, 256, 16) fp32 (and the gate backward at the VLM's and MoE's
    two-pass (4, 512, 4096) bf16 and the MDM step's (64, 256, 768) fp32).
    Bytes: each
    input read once, each output written once; flops per element: ln
    forward 8, ln backward 16, gate backward 3, loss forward 6, loss
    backward 9."""
    from repro_torch.kernels import edm_loss as EDM
    from repro_torch.kernels import fused_adaln as AD
    gen = torch.Generator(device=dev).manual_seed(3)
    rows = {n: [] for n in ("ln_modulate_fwd", "ln_modulate_bwd",
                            "gate_residual_bwd", "edm_loss_fwd",
                            "edm_loss_bwd")}
    bf16, f32 = torch.bfloat16, torch.float32

    d = 2048
    for B, S, dt, tag, key in ((8, 512, bf16, "bf16 (two-pass path)", "bf16"),
                               (8, 512, f32, "fp32", "fp32"),
                               (8, 130, bf16, "bf16, ragged S=130",
                                "ragged")):
        sets = adaln_sets(gen, dev, B, S, d, dt)
        n, elt, vec = B * S * d, sets[0][0].element_size(), B * d * 4
        shape = f"({B},{S},{d}) {tag}, fp32 slices"
        label = f"(i) ln_modulate fwd {shape}"
        say(f"[kernels] {label}: "
            f"{adaln_plan('ln_modulate_fwd', sets[0][0], sets[0][1])}")
        rows["ln_modulate_fwd"].append(rowwise_case(
            label, lambda x, sc, sh, g: AD.ln_modulate_fwd(x, sc, sh),
            lambda x, sc, sh, g: AD.ln_modulate_ref(x, sc, sh),
            sets, 2 * n * elt + 2 * vec, 8 * n,
            PRIOR_LN_FWD_MS if key == "bf16" else None))
        label = f"(i) ln_modulate bwd {shape}"
        say(f"[kernels] {label}: "
            f"{adaln_plan('ln_modulate_bwd', sets[0][0], sets[0][1])}")
        rows["ln_modulate_bwd"].append(rowwise_case(
            label, lambda x, sc, sh, g: AD.ln_modulate_bwd(x, sc, g),
            lambda x, sc, sh, g: AD.ln_modulate_bwd_ref(x, sc, g),
            sets, 3 * n * elt + 3 * vec, 16 * n, PRIOR_LN_BWD_MS[key]))
        # gate backward: the same streams as branch and cotangent
        label = f"(j) gate_residual bwd {shape}"
        say(f"[kernels] {label}: "
            f"{adaln_plan('gate_residual_bwd', sets[0][0], sets[0][1])}")
        rows["gate_residual_bwd"].append(rowwise_case(
            label, lambda x, sc, sh, g: AD.gate_residual_bwd(x, sc, g),
            lambda x, sc, sh, g: AD.gate_residual_bwd_ref(x, sc, g),
            sets, 3 * n * elt + 2 * vec, 3 * n, PRIOR_GATE_BWD_MS[key]))
    B, S, d = 256, 256, 384            # the DiT-S/2 layer's σ-gates
    sets, n = adaln_sets(gen, dev, B, S, d, f32), B * S * d
    label = (f"(m) gate_residual bwd ({B},{S},{d}) fp32 (DiT-S/2 step), fp32 "
             "slices")
    say(f"[kernels] {label}: "
        f"{adaln_plan('gate_residual_bwd', sets[0][0], sets[0][1])}")
    rows["gate_residual_bwd"].append(rowwise_case(
        label, lambda x, sc, sh, g: AD.gate_residual_bwd(x, sc, g),
        lambda x, sc, sh, g: AD.gate_residual_bwd_ref(x, sc, g),
        sets, 3 * n * 4 + 2 * B * d * 4, 3 * n, PRIOR_GATE_BWD_MS["dit"]))
    B, S, d = 4, 512, 4096             # the VLM's and MoE's two-pass gates
    sets, n = adaln_sets(gen, dev, B, S, d, bf16), B * S * d
    label = (f"(x) gate_residual bwd ({B},{S},{d}) bf16 (VLM, MoE two_pass),"
             " fp32 slices")
    say(f"[kernels] {label}: "
        f"{adaln_plan('gate_residual_bwd', sets[0][0], sets[0][1])}")
    rows["gate_residual_bwd"].append(rowwise_case(
        label, lambda x, sc, sh, g: AD.gate_residual_bwd(x, sc, g),
        lambda x, sc, sh, g: AD.gate_residual_bwd_ref(x, sc, g),
        sets, 3 * n * 2 + 2 * B * d * 4, 3 * n))
    B, S, d = 64, 256, 768             # the MDM layer's σ-gates
    sets, n = adaln_sets(gen, dev, B, S, d, f32), B * S * d
    label = (f"(q) gate_residual bwd ({B},{S},{d}) fp32 (MDM step), fp32 "
             "slices")
    say(f"[kernels] {label}: "
        f"{adaln_plan('gate_residual_bwd', sets[0][0], sets[0][1])}")
    rows["gate_residual_bwd"].append(rowwise_case(
        label, lambda x, sc, sh, g: AD.gate_residual_bwd(x, sc, g),
        lambda x, sc, sh, g: AD.gate_residual_bwd_ref(x, sc, g),
        sets, 3 * n * 4 + 2 * B * d * 4, 3 * n))
    for B, S, d, tag in ((8, 512, 2048, "(two-pass l2 path)"),
                         (8, 300, 2048, "ragged S=300"),
                         (256, 256, 16, "(DiT-S/2 l2 path)")):
        nt = -(-S // EDM.BLOCK_ROWS)
        n = B * S * d
        sets = []
        for _ in range(rotations(3 * n * 4)):
            f, z, y = (torch.randn(B, S, d, generator=gen, device=dev)
                       for _ in range(3))
            sigma = torch.rand(B, generator=gen, device=dev) * 3 + 0.01
            cs, co = EDM._coeffs(sigma, 0.5)
            g = torch.randn(B, nt, generator=gen, device=dev)
            sets.append((f, z, y, cs, co, g))
        shape = f"({B},{S},{d}) fp32 {tag}"
        rows["edm_loss_fwd"].append(rowwise_case(
            f"(k) edm_loss fwd {shape}",
            lambda f, z, y, cs, co, g: EDM.edm_loss_fwd(f, z, y, cs, co),
            lambda f, z, y, cs, co, g: EDM.edm_loss_partials_ref(
                f, z, y, cs, co, EDM.BLOCK_ROWS),
            sets, 3 * n * 4 + 2 * B * 4 + B * nt * 4, 6 * n))
        rows["edm_loss_bwd"].append(rowwise_case(
            f"(k) edm_loss bwd {shape}",
            lambda f, z, y, cs, co, g: EDM.edm_loss_bwd(f, z, y, cs, co, g),
            lambda f, z, y, cs, co, g: EDM.edm_loss_bwd_ref(
                f, z, y, cs, co, g, EDM.BLOCK_ROWS),
            sets, 6 * n * 4 + 2 * B * 4 + B * nt * 4, 9 * n))
    return rows


def phase_euler(dev) -> dict:
    """The Euler step's kernels: the DiT sampler's (256, 256, 16) fp32 (the
    main case), the recurrent sampler's (8, 512, 512) fp32 with F the
    strided noisy half of a (8, 1024, 512) stream (read in place: no copy,
    so the bytes are those of the half), a bf16 case, a ragged S and ViT's
    predict (128, 1, 128) with F the label row of a (128, 66, 128) stream.
    Bytes:
    z, F (or g) read once, outputs written once, a and b (B,) fp32; flops 3
    per element forward, 2 backward. Then one ``torch.autograd.grad``
    through ``fused_euler`` on the card: the backward kernel must run and
    give the plain version's gradients."""
    from repro_torch.kernels import fused_adaln as AD
    gen = torch.Generator(device=dev).manual_seed(4)
    rows = {"euler_fwd": [], "euler_bwd": []}
    f32, bf16 = torch.float32, torch.bfloat16

    def coeffs(B):
        sigma = torch.rand(B, generator=gen, device=dev) * 40 + 0.01
        sigma_to = sigma * torch.rand(B, generator=gen, device=dev)
        sigma_to[0] = 0.0                     # the chain's last step
        return sigma, sigma_to

    def stream(B, S, d, dt, span):
        """F: the last S of ``span`` rows of each example (strided where
        span > S)."""
        return torch.randn(B, span, d, generator=gen,
                           device=dev).to(dt)[:, span - S:]

    for (B, S, d), dt, span, tag in (
            ((256, 256, 16), f32, 256, "DiT-S/2 sampler, 256 samples"),
            ((8, 512, 512), f32, 1024, "Huginn sampler, F strided"),
            ((8, 512, 512), bf16, 1024, "bf16, F strided"),
            ((8, 333, 512), f32, 333, "ragged S=333"),
            ((128, 1, 128), f32, 66, "ViT predict, F the label token of "
             "66")):
        n, elt = B * S * d, torch.tensor([], dtype=dt).element_size()
        sets = []
        for _ in range(rotations(3 * n * elt)):
            z = torch.randn(B, S, d, generator=gen, device=dev).to(dt)
            a, b = AD.euler_coeffs(*coeffs(B), 0.5)
            g = torch.randn(B, S, d, generator=gen, device=dev).to(dt)
            sets.append((z, stream(B, S, d, dt, span), a, b, g))
        shape = f"({B},{S},{d}) {str(dt)[6:]} {tag}"
        rows["euler_fwd"].append(rowwise_case(
            f"(l) euler fwd {shape}",
            lambda z, f, a, b, g: AD.euler_fwd(z, f, a, b),
            lambda z, f, a, b, g: AD.euler_ref(z, f, a, b),
            sets, 3 * n * elt + 2 * B * 4, 3 * n))
        rows["euler_bwd"].append(rowwise_case(
            f"(l) euler bwd {shape}",
            lambda z, f, a, b, g: AD.euler_bwd(g, a, b),
            lambda z, f, a, b, g: AD.euler_bwd_ref(g, a, b),
            sets, 3 * n * elt + 2 * B * 4, 2 * n))

    B, S, d = 8, 512, 512
    z = torch.randn(B, S, d, generator=gen, device=dev).requires_grad_()
    f2 = torch.randn(B, 2 * S, d, generator=gen, device=dev).requires_grad_()
    sigma, sigma_to = coeffs(B)
    n0 = AD.euler_bwd.launches
    out = AD.fused_euler(z, f2[:, S:], sigma, sigma_to, 0.5)
    g = torch.randn(B, S, d, generator=gen, device=dev)
    dz, df2 = torch.autograd.grad(out, (z, f2), g)
    torch.cuda.synchronize()
    if AD.euler_bwd.launches != n0 + 1:
        raise SmokeError("autograd through fused_euler did not launch the "
                         "backward kernel")
    want = AD.euler_bwd_ref(g, *AD.euler_coeffs(sigma, sigma_to, 0.5))
    err = compare("fused_euler autograd", (dz, df2[:, S:]), want)
    if (df2[:, :S] != 0).any():
        raise SmokeError("fused_euler autograd: gradient outside F's view")
    say(f"[kernels] autograd.grad through fused_euler (8,512,512), F "
        f"strided: euler_bwd launched, max|err| {err:.2e} against the plain "
        f"backward")
    return rows


def attention_work(cfg, B, H, KV, S, Sk, hd, elt):
    """Bytes and flops of each attention kernel at these shapes (S queries,
    Sk keys): every input read once, every output written once (fp32 lse
    and delta); flops over the (q, k) pairs this mask keeps: 4 hd per pair
    and head for the forward (q.k, p.v), 6 hd for dq (q.k, dO.v, ds.k), 8 hd
    for dk/dv."""
    from repro_torch.kernels import flash_attention as FA
    pairs = int(FA.keep_mask(cfg, S, Sk).sum())
    q_b, kv_b, row_b = B * H * S * hd * elt, B * KV * Sk * hd * elt, \
        B * H * S * 4
    return {"flash_attention_fwd": (2 * q_b + 2 * kv_b + row_b,
                                    4 * hd * pairs * B * H),
            "flash_attention_bwd_dq": (3 * q_b + 2 * kv_b + 2 * row_b,
                                       6 * hd * pairs * B * H),
            "flash_attention_bwd_dkv": (2 * q_b + 4 * kv_b + 2 * row_b,
                                        8 * hd * pairs * B * H)}


def attention_case(label, kind, *, B, H, KV, S, hd, dtype, Sk=None,
                   window=None, mask_seq=None, dev, gen) -> dict:
    """The three attention kernels at one shape (S queries, Sk keys,
    default S), against their plain versions (the backward ones on the
    kernel forward's lse and delta, so each kernel is checked alone);
    (B, S, H, hd) tensors passed as transposed views, as the model passes
    them. Library yardstick: ``scaled_dot_product_attention`` with the same
    boolean mask, forward, and forward + backward less forward (one call
    computes dq, dk, dv), each the median of three CUDA-graph readings."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    cfg = FA.FlashConfig(kind, window=window, mask_seq=mask_seq)
    Sk = S if Sk is None else Sk
    mk = lambda n, L: torch.randn(B, L, n, hd, generator=gen,  # noqa: E731
                                  device=dev).to(dtype).transpose(1, 2)
    q, k, v, do = mk(H, S), mk(KV, Sk), mk(KV, Sk), mk(H, S)
    out, lse = FA.flash_attention_fwd(q, k, v, cfg)
    delta = FA.attention_delta(out, do)
    dq = FA.flash_attention_bwd_dq(q, k, v, do, lse, delta, cfg)
    dk, dv = FA.flash_attention_bwd_dkv(q, k, v, do, lse, delta, cfg)
    torch.cuda.synchronize()
    calls = {
        "flash_attention_fwd": (
            lambda i: FA.flash_attention_fwd(q, k, v, cfg),
            lambda i: FA.flash_attention_fwd_ref(q, k, v, cfg)),
        "flash_attention_bwd_dq": (
            lambda i: FA.flash_attention_bwd_dq(q, k, v, do, lse, delta, cfg),
            lambda i: FA._bwd_dq_ref(q, k, v, do, lse, delta, cfg)),
        "flash_attention_bwd_dkv": (
            lambda i: FA.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                 cfg),
            lambda i: FA._bwd_dkv_ref(q, k, v, do, lse, delta, cfg)),
    }
    got = {"flash_attention_fwd": (out, lse), "flash_attention_bwd_dq": dq,
           "flash_attention_bwd_dkv": (dk, dv)}
    mask = FA.keep_mask(cfg, S, Sk, dev)
    gqa = {"enable_gqa": True} if H != KV else {}
    # GQA in one call needs torch >= 2.5 (enable_gqa); else no yardstick
    lib_fwd = lib_bwd = lib_spread = None
    if not gqa or tuple(int(x) for x in
                        torch.__version__.split(".")[:2]) >= (2, 5):
        # timed as the kernels are (CUDA-graph replay, device time only);
        # the backward is forward + backward less forward, both captured
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))

        def sdpa_fwd_bwd(i):
            o = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask,
                                               **gqa)
            torch.autograd.grad(o, (qg, kg, vg), do)
        fwd_t = device_trials(lambda i: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, **gqa), 1, calls=3, reps=3, trials=3)
        both_t = device_trials(sdpa_fwd_bwd, 1, calls=3, reps=3, trials=3)
        lib_fwd, both = statistics.median(fwd_t), statistics.median(both_t)
        lib_bwd = both - lib_fwd
        lib_spread = {"fwd": [min(fwd_t), max(fwd_t)],
                      "fwd_bwd": [min(both_t), max(both_t)]}
    work = attention_work(cfg, B, H, KV, S, Sk, hd, q.element_size())
    peak = PEAK_BF16 if dtype == torch.bfloat16 else max(PEAK_FP32,
                                                         PEAK_FP32_TC)
    rows = {}
    for name, (kern, ref) in calls.items():
        err = compare(f"{name} {label}", got[name], ref(0),
                      bf16_rounding=True)
        ms = device_ms(kern, 1, calls=3, reps=3)
        plain_ms = device_ms(ref, 1, calls=2, reps=2)
        nbytes, flops = work[name]
        bound_ms, by = bound(nbytes, flops, peak)
        lib = lib_fwd if name == "flash_attention_fwd" else lib_bwd
        rows[name] = {"case": label, "max_abs_err": err, "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": by, "library_ms": lib,
                      "library_spread_ms": lib_spread, "bytes": nbytes,
                      "flops": flops}
        say(f"[kernels] {name} {label}: max|err| {err:.2e} | kernel "
            f"{ms:.4f} ms device | bound {bound_ms:.4f} ms ({by}; "
            f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP) | plain "
            f"{plain_ms:.3f} ms | library (sdpa, bool mask"
            f"{', fwd' if name.endswith('fwd') else ', whole backward'}) "
            f"{'none' if lib is None else f'{lib:.4f} ms'}"
            + ("" if lib_spread is None else
               f" (3 readings: fwd {lib_spread['fwd'][0]:.4f}-"
               f"{lib_spread['fwd'][1]:.4f}, fwd+bwd "
               f"{lib_spread['fwd_bwd'][0]:.4f}-"
               f"{lib_spread['fwd_bwd'][1]:.4f} ms)"))
    return rows


def phase_attention(dev) -> dict:
    """Attention kernels at the training path's shapes: the DB step's
    db_concat stream (8 x 1024 rows, mask_seq 512) and the e2e step's causal
    512, in bf16 (the path's policy) and fp32, one GQA G=4 window case at hd
    128, the two calls of an olmo-1b two-pass layer (hd 128), the DiT-S/2
    layer's ``full`` attention and Huginn's causal and db_concat ones (fp32,
    hd 64), ViT's (fp32, hd 32) and the MDM's (fp32, hd 64) ``full`` ones,
    the hybrid's window and two_pass ones (fp32, hd 112), h2o-danube3's
    (hd 120, G=4, both dtypes) and whisper-small's ``full`` ones (the
    encoder at S=1500 and the cross-attention at 896 queries over 1500
    keys, both dtypes) and the VLM's cross-attention in training (GQA 4:1,
    hd 128, 1024 and 512 queries over 1601 image tokens, both dtypes). The
    first case of each kernel is its main case."""
    gen = torch.Generator(device=dev).manual_seed(2)
    rows = {n: [] for n in ATTN}
    bf16, f32 = torch.bfloat16, torch.float32
    # ``pr16``: the bf16 (dq, dk/dv) ms of the CUDA-core kernels that the
    # tensor-core ones replaced, as PERF.md records them from an earlier
    # run of this script (NVIDIA H100 80GB HBM3, 700.00 W); ``cuda_core_fwd``
    # and ``cuda_core_bwd``: the fp32 forward's and (dq, dk/dv)'s on the CUDA
    # cores, likewise. Printed beside this run's times for comparison; not
    # measured here, so kept out of the rows and the kernels line.
    cases = [
        ("(e) db_concat B=8 H=32 S=2x512 hd=64 bf16 (DB step)", "db_concat",
         dict(B=8, H=32, KV=32, S=1024, hd=64, dtype=bf16, mask_seq=512,
              pr16=(1.5059, 1.9363))),
        ("(e) db_concat B=8 H=32 S=2x512 hd=64 fp32", "db_concat",
         dict(B=8, H=32, KV=32, S=1024, hd=64, dtype=f32, mask_seq=512)),
        ("(f) causal B=8 H=32 S=512 hd=64 bf16 (e2e step)", "causal",
         dict(B=8, H=32, KV=32, S=512, hd=64, dtype=bf16,
              pr16=(0.7224, 0.8770))),
        ("(f) causal B=8 H=32 S=512 hd=64 fp32", "causal",
         dict(B=8, H=32, KV=32, S=512, hd=64, dtype=f32)),
        # ragged: 16 key tiles, the last one 40 keys long
        ("(f) causal B=8 H=32 S=1000 hd=64 bf16 (ragged)", "causal",
         dict(B=8, H=32, KV=32, S=1000, hd=64, dtype=bf16,
              pr16=(2.4825, 3.0347))),
        ("(g) window=256 GQA H=32 KV=8 S=1024 hd=128 bf16", "window",
         dict(B=4, H=32, KV=8, S=1024, hd=128, dtype=bf16, window=256,
              pr16=(1.5950, 2.0039))),
        ("(g) window=256 GQA H=32 KV=8 S=1024 hd=128 fp32", "window",
         dict(B=4, H=32, KV=8, S=1024, hd=128, dtype=f32, window=256)),
        # the two calls of an olmo-1b two-pass layer (phase 8)
        ("(h) causal B=8 H=16 S=512 hd=128 bf16 (two-pass clean stream)",
         "causal", dict(B=8, H=16, KV=16, S=512, hd=128, dtype=bf16,
                        pr16=(1.0059, 1.0849))),
        ("(h) two_pass B=8 H=16 Sq=512 Sk=2x512 hd=128 bf16 (two-pass "
         "noisy stream)", "two_pass",
         dict(B=8, H=16, KV=16, S=512, Sk=1024, hd=128, dtype=bf16,
              mask_seq=512, pr16=(1.1898, 1.3607))),
        # the DiT-S/2 step's layers (phase 10) and Huginn's (phase 11)
        ("(m) full B=256 H=6 S=256 hd=64 fp32 (DiT-S/2 step)", "full",
         dict(B=256, H=6, KV=6, S=256, hd=64, dtype=f32,
              cuda_core_fwd=1.3070, cuda_core_bwd=(1.5936, 2.1385))),
        ("(n) causal B=8 H=8 S=512 hd=64 fp32 (Huginn prelude, coda, "
         "baseline core)", "causal",
         dict(B=8, H=8, KV=8, S=512, hd=64, dtype=f32)),
        ("(n) db_concat B=8 H=8 S=2x512 hd=64 fp32 (Huginn db core)",
         "db_concat", dict(B=8, H=8, KV=8, S=1024, hd=64, dtype=f32,
                           mask_seq=512)),
        # ViT's layers (phase 12: hd 32, 66 tokens, so the second 64-row
        # tile of each side holds 2 rows) and the MDM's (phase 13)
        ("(p) full B=128 H=4 S=66 hd=32 fp32 (ViT step)", "full",
         dict(B=128, H=4, KV=4, S=66, hd=32, dtype=f32)),
        ("(q) full B=64 H=12 S=256 hd=64 fp32 (MDM step)", "full",
         dict(B=64, H=12, KV=12, S=256, hd=64, dtype=f32)),
        # the hybrid's shared block in training (phase 17: zamba2-7b, fp32
        # under every policy, hd 112, window 4096): the DB step's clean
        # stream (and the e2e step's one stream) and its noisy stream
        ("(z) window=4096 B=4 H=32 S=512 hd=112 fp32 (hybrid DB clean "
         "stream, e2e)", "window",
         dict(B=4, H=32, KV=32, S=512, hd=112, dtype=f32, window=4096)),
        ("(z) two_pass B=4 H=32 Sq=512 Sk=2x512 hd=112 fp32 (hybrid DB "
         "noisy stream)", "two_pass",
         dict(B=4, H=32, KV=32, S=512, Sk=1024, hd=112, dtype=f32,
              mask_seq=512)),
        # h2o-danube3-4b's training (phase 18: hd 120 in hd 128's tiles,
        # 32 query heads on 8 KV heads): the concat DB step and its fp32
        # check, the two-pass step's noisy stream, the e2e step's window
        # (4096: it does not bind at 512), and (g)'s shape at hd 120, whose
        # window binds, beside hd 128 there
        ("(s) db_concat B=8 H=32 KV=8 S=2x512 hd=120 bf16 (h2o DB step)",
         "db_concat", dict(B=8, H=32, KV=8, S=1024, hd=120, dtype=bf16,
                           mask_seq=512)),
        ("(s) db_concat B=8 H=32 KV=8 S=2x512 hd=120 fp32 (h2o fp32 check)",
         "db_concat", dict(B=8, H=32, KV=8, S=1024, hd=120, dtype=f32,
                           mask_seq=512)),
        ("(s) two_pass B=8 H=32 KV=8 Sq=512 Sk=2x512 hd=120 bf16 (h2o "
         "two-pass noisy stream)", "two_pass",
         dict(B=8, H=32, KV=8, S=512, Sk=1024, hd=120, dtype=bf16,
              mask_seq=512)),
        ("(s) window=4096 B=8 H=32 KV=8 S=512 hd=120 bf16 (h2o e2e step)",
         "window", dict(B=8, H=32, KV=8, S=512, hd=120, dtype=bf16,
                        window=4096)),
        ("(s) window=256 GQA H=32 KV=8 S=1024 hd=120 bf16 (as (g))",
         "window", dict(B=4, H=32, KV=8, S=1024, hd=120, dtype=bf16,
                        window=256)),
        ("(s) window=256 GQA H=32 KV=8 S=1024 hd=120 fp32 (as (g))",
         "window", dict(B=4, H=32, KV=8, S=1024, hd=120, dtype=f32,
                        window=256)),
        # whisper-small (phase 19: hd 64, 12 heads, 1500 audio frames, so
        # the last key tile holds 28 keys): the encoder's self-attention
        # (bf16 in the DB steps, fp32 at each serving admission and in the
        # fp32 check) and the decoder's cross-attention over the memory
        # from the DB concat stream's 2 x 448 queries, Sq != Sk
        ("(w) full B=8 H=12 S=1500 hd=64 bf16 (whisper encoder)", "full",
         dict(B=8, H=12, KV=12, S=1500, hd=64, dtype=bf16)),
        ("(w) full B=8 H=12 S=1500 hd=64 fp32 (whisper encoder: serving, "
         "fp32 check)", "full",
         dict(B=8, H=12, KV=12, S=1500, hd=64, dtype=f32)),
        ("(w) full B=8 H=12 Sq=896 Sk=1500 hd=64 bf16 (whisper cross, DB "
         "concat stream)", "full",
         dict(B=8, H=12, KV=12, S=896, Sk=1500, hd=64, dtype=bf16)),
        ("(w) full B=8 H=12 Sq=896 Sk=1500 hd=64 fp32 (whisper cross)",
         "full", dict(B=8, H=12, KV=12, S=896, Sk=1500, hd=64, dtype=f32)),
        # llama-3.2-vision-11b's cross layer in training (phase 20: 32
        # query heads on 8 KV heads of 128 over 1601 image tokens, so the
        # last key tile holds one key): the DB concat stream's 2 x 512
        # queries and the two-pass and e2e streams' 512
        ("(x) full B=4 H=32 KV=8 Sq=1024 Sk=1601 hd=128 bf16 (VLM cross, "
         "DB concat stream)", "full",
         dict(B=4, H=32, KV=8, S=1024, Sk=1601, hd=128, dtype=bf16)),
        ("(x) full B=4 H=32 KV=8 Sq=1024 Sk=1601 hd=128 fp32 (VLM cross, "
         "fp32 check)", "full",
         dict(B=4, H=32, KV=8, S=1024, Sk=1601, hd=128, dtype=f32)),
        ("(x) full B=4 H=32 KV=8 Sq=512 Sk=1601 hd=128 bf16 (VLM cross, "
         "two_pass and e2e)", "full",
         dict(B=4, H=32, KV=8, S=512, Sk=1601, hd=128, dtype=bf16)),
        ("(x) full B=4 H=32 KV=8 Sq=512 Sk=1601 hd=128 fp32 (VLM cross)",
         "full", dict(B=4, H=32, KV=8, S=512, Sk=1601, hd=128, dtype=f32)),
    ]
    for label, kind, kw in cases:
        pr16 = kw.pop("pr16", None)
        cuda_core_fwd = kw.pop("cuda_core_fwd", None)
        cuda_core_bwd = kw.pop("cuda_core_bwd", None)
        got = attention_case(label, kind, dev=dev, gen=gen, **kw)
        for name, row in got.items():
            rows[name].append(row)
        if pr16 is not None:
            say(f"[kernels] {label}: dq / dk/dv {got[ATTN[1]]['ms']:.4f} / "
                f"{got[ATTN[2]]['ms']:.4f} ms this run; PR 16's CUDA-core "
                f"kernels {pr16[0]:.4f} / {pr16[1]:.4f} ms (recorded in "
                "PERF.md, NVIDIA H100 80GB HBM3, 700.00 W; not this run)")
        if cuda_core_fwd is not None:
            say(f"[kernels] {label}: forward {got[ATTN[0]]['ms']:.4f} ms "
                f"this run; the CUDA-core fp32 forward it replaced "
                f"{cuda_core_fwd:.4f} ms (recorded in PERF.md, NVIDIA H100 "
                "80GB HBM3, 700.00 W; not this run)")
        if cuda_core_bwd is not None:
            dq_ms, dkv_ms = got[ATTN[1]]["ms"], got[ATTN[2]]["ms"]
            lib = got[ATTN[1]]["library_ms"]
            say(f"[kernels] {label}: dq / dk/dv {dq_ms:.4f} / {dkv_ms:.4f} "
                f"ms this run; the CUDA-core fp32 kernels they replaced "
                f"{cuda_core_bwd[0]:.4f} / {cuda_core_bwd[1]:.4f} ms "
                "(recorded in PERF.md, NVIDIA H100 80GB HBM3, 700.00 W; not "
                f"this run); dq + dk/dv {dq_ms + dkv_ms:.4f} ms against "
                "SDPA's whole backward "
                f"{'none' if lib is None else f'{lib:.4f} ms'} this run")
    return rows


def phase_kernels(dev) -> dict:
    from repro_torch.kernels import flash_decode as FD
    gen = torch.Generator(device=dev).manual_seed(1)
    ragged = [0, 128, 200, 333, 416, 480, 511, 544]
    starts = [0, 64, 128, 192, 256, 320, 384, 448]
    rows = {"flash_decode": [], "flash_prefill": [], "gate_residual": []}
    bf16, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    # (a) decode at stablelm widths: the probe's fp32 q, the commit's bf16 q
    rows["flash_decode"].append(paged_case(
        "(a) decode B=8 KV=32 G=1 hd=64 bf16 pages, fp32 q (probe)",
        "flash_decode", KV=32, G=1, hd=64, page_dtype=bf16, q_dtype=f32,
        window=None, lengths=ragged, dev=dev, gen=gen,
        prior=PRIOR_DECODE_A_MS))
    rows["flash_decode"].append(paged_case(
        "(a) decode B=8 KV=32 G=1 hd=64 bf16 pages, bf16 q (commit)",
        "flash_decode", KV=32, G=1, hd=64, page_dtype=bf16, q_dtype=bf16,
        window=None, lengths=ragged, dev=dev, gen=gen))
    # (b) GQA + window + int8 at h2o-danube3 widths
    rows["flash_decode"].append(paged_case(
        "(b) decode KV=8 G=4 hd=120 window=64 int8 pages",
        "flash_decode", KV=8, G=4, hd=120, page_dtype=i8, q_dtype=bf16,
        window=64, lengths=ragged, dev=dev, gen=gen))
    rows["flash_prefill"].append(paged_case(
        "(b) prefill C=64 KV=8 G=4 hd=120 window=64 int8 pages",
        "flash_prefill", KV=8, G=4, hd=120, page_dtype=i8, q_dtype=bf16,
        window=64, lengths=starts, dev=dev, gen=gen, C=CHUNK))
    # (o) decode split across blocks where the pairs do not fill the SMs:
    # KV=8 G=4 hd 128 (llama-3.2-vision-11b, phi3.5-moe, grok-1) at phase
    # 4's lengths x8, against one block a pair
    long = [8 * n for n in ragged]
    split = dict(KV=8, G=4, hd=128, page_dtype=bf16, q_dtype=bf16,
                 window=None, lengths=long, cap=8 * (PROMPT + MAX_NEW),
                 dev=dev)
    row = paged_case("(o) decode B=8 KV=8 G=4 hd=128 bf16 pages, lengths "
                     "to 4352 (split)", "flash_decode", gen=gen, **split)
    heuristic = FD.decode_splits
    FD.decode_splits = lambda *args: 1
    try:
        one = paged_case("(o) the same, one block a pair", "flash_decode",
                         gen=torch.Generator(device=dev).manual_seed(1),
                         **split)
    finally:
        FD.decode_splits = heuristic
    row["one_block_ms"] = one["ms"]
    rows["flash_decode"].append(row)
    say(f"[kernels] (o) decode split: {row['ms']:.4f} ms against one block "
        f"a pair {one['ms']:.4f} ms, this run")
    # (r) llama-3.2-vision-11b's paged shapes (KV=8 G=4 hd 128, phase 15):
    # the probe's fp32 q over bf16 pages at phase 4's lengths, and the
    # commit's chunk on the tensor cores
    rows["flash_decode"].append(paged_case(
        "(r) decode B=8 KV=8 G=4 hd=128 bf16 pages, fp32 q (VLM probe)",
        "flash_decode", KV=8, G=4, hd=128, page_dtype=bf16, q_dtype=f32,
        window=None, lengths=ragged, dev=dev, gen=gen))
    rows["flash_prefill"].append(paged_case(
        "(r) prefill C=64 B=8 KV=8 G=4 hd=128 bf16 pages, bf16 q (VLM)",
        "flash_prefill", KV=8, G=4, hd=128, page_dtype=bf16, q_dtype=bf16,
        window=None, lengths=starts, dev=dev, gen=gen, C=CHUNK))
    # (z) zamba2-7b's paged shapes (KV=32 G=1 hd 112, phase 16): the
    # hybrid computes in fp32 over the bf16 policy's pages, so its probe
    # and its commit send fp32 q to decode and its chunk takes the 3xTF32
    # route; then int8 pages under a 64-key window the lengths pass, and
    # the tensor-core route at hd 112 (bf16 q, off the hybrid's path)
    zamba = dict(KV=32, G=1, hd=112, dev=dev, gen=gen)
    rows["flash_decode"].append(paged_case(
        "(z) decode B=8 KV=32 G=1 hd=112 window=4096 bf16 pages, fp32 q "
        "(hybrid probe and commit)", "flash_decode", page_dtype=bf16,
        q_dtype=f32, window=4096, lengths=ragged, **zamba))
    rows["flash_prefill"].append(paged_case(
        "(z) prefill C=64 B=8 KV=32 G=1 hd=112 window=4096 bf16 pages, "
        "fp32 q (hybrid)", "flash_prefill", page_dtype=bf16, q_dtype=f32,
        window=4096, lengths=starts, C=CHUNK, **zamba))
    rows["flash_decode"].append(paged_case(
        "(z) decode B=8 KV=32 G=1 hd=112 window=64 int8 pages, fp32 q",
        "flash_decode", page_dtype=i8, q_dtype=f32, window=64,
        lengths=ragged, **zamba))
    rows["flash_prefill"].append(paged_case(
        "(z) prefill C=64 B=8 KV=32 G=1 hd=112 window=64 int8 pages, fp32 q",
        "flash_prefill", page_dtype=i8, q_dtype=f32, window=64,
        lengths=starts, C=CHUNK, **zamba))
    rows["flash_prefill"].append(paged_case(
        "(z) prefill C=64 B=8 KV=32 G=1 hd=112 bf16 pages, bf16 q "
        "(tensor cores)", "flash_prefill", page_dtype=bf16, q_dtype=bf16,
        window=None, lengths=starts, C=CHUNK, **zamba))
    # (c) prefill at stablelm widths (commit_prompt_chunk: bf16 q)
    rows["flash_prefill"].insert(0, paged_case(
        "(c) prefill C=64 B=8 KV=32 G=1 hd=64 bf16 pages, bf16 q",
        "flash_prefill", KV=32, G=1, hd=64, page_dtype=bf16, q_dtype=bf16,
        window=None, lengths=starts, dev=dev, gen=gen, C=CHUNK,
        prior=PRIOR_PREFILL_C_MS))
    # (c) through the 3xTF32 route: the fp32 policy's prefill (fp32 q and
    # pages) and the fp32_kvint8 policy's (fp32 q, int8 pages)
    rows["flash_prefill"].append(paged_case(
        "(c) prefill C=64 B=8 KV=32 G=1 hd=64 fp32 pages, fp32 q",
        "flash_prefill", KV=32, G=1, hd=64, page_dtype=f32, q_dtype=f32,
        window=None, lengths=starts, dev=dev, gen=gen, C=CHUNK,
        prior=PRIOR_PREFILL_C_FP32_MS))
    rows["flash_prefill"].append(paged_case(
        "(c) prefill C=64 B=8 KV=32 G=1 hd=64 int8 pages, fp32 q",
        "flash_prefill", KV=32, G=1, hd=64, page_dtype=i8, q_dtype=f32,
        window=None, lengths=starts, dev=dev, gen=gen, C=CHUNK))
    # (d) gate-residual: the probe's (8,1,2048) fp32, a (8,64,2048) bf16
    rows["gate_residual"].append(gate_case(
        "(d) gate_residual (8,1,2048) fp32, fp32 gate slice", (8, 1, 2048),
        f32, f32, dev, gen, prior=0.0017))
    rows["gate_residual"].append(gate_case(
        "(d) gate_residual (8,64,2048) bf16, bf16 gate slice", (8, 64, 2048),
        bf16, bf16, dev, gen))
    # (m) the DiT-S/2 layer's two σ-gates (phase 10: batch 256, d 384)
    rows["gate_residual"].append(gate_case(
        "(m) gate_residual (256,256,384) fp32, fp32 gate slice (DiT-S/2)",
        (256, 256, 384), f32, f32, dev, gen, prior=0.1013))
    # (q) the MDM layer's two σ-gates (phase 13: batch 64 x 256, d 768)
    rows["gate_residual"].append(gate_case(
        "(q) gate_residual (64,256,768) fp32, fp32 gate slice (MDM)",
        (64, 256, 768), f32, f32, dev, gen))
    # (r) the VLM probe's gates (phase 15: d 4096)
    rows["gate_residual"].append(gate_case(
        "(r) gate_residual (8,1,4096) fp32, fp32 gate slice (VLM probe)",
        (8, 1, 4096), f32, f32, dev, gen))
    # (z) the hybrid probe's gates (phase 16: d 3584)
    rows["gate_residual"].append(gate_case(
        "(z) gate_residual (8,1,3584) fp32, fp32 gate slice (hybrid probe)",
        (8, 1, 3584), f32, f32, dev, gen))
    # (u) the xLSTM probe's gates (phase 22: d 768, a (B, 3d) AdaLN head;
    # the strided slice is of the same width)
    rows["gate_residual"].append(gate_case(
        "(u) gate_residual (8,1,768) fp32, fp32 gate slice (xLSTM probe)",
        (8, 1, 768), f32, f32, dev, gen))
    # (x) the two-pass noisy stream's gates at d 4096 (phases 20 and 21:
    # 4 x 512 bf16 rows, the gates fp32 slices of the AdaLN heads)
    rows["gate_residual"].append(gate_case(
        "(x) gate_residual (4,512,4096) bf16, fp32 gate slice (VLM, MoE "
        "two_pass)", (4, 512, 4096), bf16, f32, dev, gen))
    return rows


# ---------------------------------------------------------------------------
# launch counts a path must show
# ---------------------------------------------------------------------------

def expected_counts(**nonzero) -> dict:
    """Every kernel's count: the named ones, the rest 0."""
    from repro_torch import kernels as K
    unknown = set(nonzero) - set(K.WRAPPERS)
    if unknown:
        raise SmokeError(f"no kernel wrapper named {sorted(unknown)}")
    return {**{n: 0 for n in K.WRAPPERS}, **nonzero}


def check_counts(tag: str, counts: dict, expect: dict) -> None:
    if counts != expect:
        raise SmokeError(f"{tag}: launch counts {counts} != path arithmetic "
                         f"{expect}")


def db_step_counts(dbm, size: int) -> dict:
    """Launches of one DB step over a block of ``size`` units (a dense
    layer, or the hybrid's Mamba layers and one application of its shared
    block). concat: one attention forward, dq and dk/dv per layer (the
    clean||noisy stream carries a cond_mask, so no AdaLN kernel). two_pass:
    per unit's attention a causal (the hybrid: window) clean call and a
    two_pass noisy call, whose backward runs for all but the last unit's
    clean call (its output reaches no loss); on the noisy stream two
    gate-residual calls a transformer layer and one a Mamba layer and, for
    a non-parametric LayerNorm, two ln-modulate calls, forward and
    backward. l2: one EDM loss forward and backward. The encoder-decoder
    (``enc_decoder_counts``) adds its cross-attention and its encoder; the
    VLM's units are counted by ``vlm_step_counts``. A MoE layer adds no
    launch (its router and experts are plain products, as in JAX), but in
    two_pass the last layer's clean call has its backward too: the clean
    stream's router aux loss is in the loss. The xLSTM: ``xl_step_counts``."""
    l2 = int(dbm.db.loss == "l2")
    if dbm.cfg.xlstm is not None:
        return xl_step_counts(size, l2)
    if dbm.cfg.n_encoder_layers:
        return enc_decoder_counts(dbm, size, l2)
    if hasattr(dbm.model, "k_self"):
        return vlm_step_counts(dbm, size, l2)
    if dbm.causal_mode == "concat":
        return expected_counts(**{n: size for n in ATTN}, edm_loss_fwd=l2,
                               edm_loss_bwd=l2)
    ln = 2 * size if dbm.cfg.norm == "nonparam_ln" else 0
    gates = (2 + getattr(dbm.model, "inner", 0)) * size
    bwd = 2 * size - (0 if dbm.cfg.moe else 1)
    return expected_counts(
        flash_attention_fwd=2 * size, flash_attention_bwd_dq=bwd,
        flash_attention_bwd_dkv=bwd, gate_residual=gates,
        gate_residual_bwd=gates, ln_modulate_fwd=ln, ln_modulate_bwd=ln,
        edm_loss_fwd=l2, edm_loss_bwd=l2)


def xl_step_counts(size: int, l2: int = 0) -> dict:
    """Launches of an xLSTM DB step over ``size`` units (always two-pass):
    per unit two gate-residual calls on the noisy stream (its sLSTM and
    mLSTM blocks), forward and backward; the clean stream's residuals are
    plain adds and the cells plain torch, and the LayerNorm is parametric
    (no ln-modulate). l2: one EDM loss forward and backward."""
    return expected_counts(gate_residual=2 * size,
                           gate_residual_bwd=2 * size, edm_loss_fwd=l2,
                           edm_loss_bwd=l2)


def enc_decoder_counts(dbm, size: int, l2: int = 0,
                       e2e: bool = False) -> dict:
    """Launches of an encoder-decoder step over ``size`` decoder layers:
    the encoder's ``full`` attention once per encoder layer, forward and
    backward (the encoder is periphery: every step trains it). Per decoder
    layer, concat or e2e: a self and a cross call; two_pass: a clean and a
    noisy self call and a clean and a noisy cross call, whose backward runs
    for all but the last layer's clean ones (their outputs reach no loss).
    No AdaLN kernel: the decoder gates in plain ops and its LayerNorm is
    parametric, as in JAX. l2: one EDM loss forward and backward."""
    enc = dbm.cfg.n_encoder_layers
    if e2e or dbm.causal_mode == "concat":
        calls = {n: 2 * size + enc for n in ATTN}
    else:
        calls = {ATTN[0]: 4 * size + enc, ATTN[1]: 4 * size - 2 + enc,
                 ATTN[2]: 4 * size - 2 + enc}
    return expected_counts(**calls, edm_loss_fwd=l2, edm_loss_bwd=l2)


def vlm_step_counts(dbm, size: int, l2: int = 0) -> dict:
    """Launches of a VLM DB step over ``size`` units of ``k_self`` self
    layers and a cross layer. concat: one attention call a layer (the
    cross layer's a ``full`` call over the images), forward and backward;
    the clean||noisy stream carries a cond_mask, so no AdaLN kernel.
    two_pass: per self layer a clean and a noisy call and two gate-residual
    calls on the noisy stream; per cross layer a ``full`` call and two
    gate-residual calls for each stream (JAX's: both streams σ-gated
    there). The backward runs for all but the last unit's last clean self
    call and its clean cross call and two clean gates (their outputs reach
    no loss). RMSNorm is parametric: no ln-modulate. l2: one EDM loss
    forward and backward."""
    k = dbm.model.k_self
    if dbm.causal_mode == "concat":
        return expected_counts(**{n: size * (k + 1) for n in ATTN},
                               edm_loss_fwd=l2, edm_loss_bwd=l2)
    calls, gates = size * (2 * k + 2), size * (2 * k + 4)
    return expected_counts(
        flash_attention_fwd=calls, flash_attention_bwd_dq=calls - 2,
        flash_attention_bwd_dkv=calls - 2, gate_residual=gates,
        gate_residual_bwd=gates - 2, edm_loss_fwd=l2, edm_loss_bwd=l2)


def e2e_counts(dbm) -> dict:
    """Launches of an e2e step: one attention forward, dq and dk/dv per
    unit (a dense or MoE layer, an application of the hybrid's shared
    block), per layer for the VLM (its cross layers' ``full`` calls
    among them); ``enc_decoder_counts`` for the encoder-decoder; none for
    the xLSTM (no attention, and with no σ its gates are plain adds)."""
    if dbm.cfg.n_encoder_layers:
        return enc_decoder_counts(dbm, dbm.cfg.n_layers, e2e=True)
    if dbm.cfg.xlstm is not None:
        return expected_counts()
    n = (dbm.cfg.n_layers if hasattr(dbm.model, "k_self")
         else dbm.model.n_units)
    return expected_counts(**{k: n for k in ATTN})


def add_counts(total: dict, counts: dict) -> None:
    for n, c in counts.items():
        total[n] = total.get(n, 0) + c


# ---------------------------------------------------------------------------
# 4. full-width serve, 5. fp32 cross-check
# ---------------------------------------------------------------------------

def build_model(dev):
    from repro_torch.configs import DEFAULT_DB, get_config
    from repro_torch.core.blocks import DiffusionBlocksModel
    cfg = get_config(ARCH)
    dbm = DiffusionBlocksModel(cfg, DEFAULT_DB)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = dbm.init(gen)
    # AdaLN heads are zero at init (identity modulation, gates of 1):
    # randomise them so the σ conditioning and the gate kernel do real work
    ad = params["layers"]["adaln"]
    for k in ("w", "b"):
        ad[k].normal_(0.0, 0.02, generator=gen)
    return cfg, dbm, params, gen


def prompts_np(vocab: int, seed: int = 0):
    import numpy as np
    rs = np.random.RandomState(seed)
    prompts = rs.randint(0, vocab, size=(BATCH, PROMPT))
    plens = rs.randint(PROMPT // 4, PROMPT + 1, size=BATCH)
    plens[0], plens[-1] = PROMPT // 4, PROMPT
    return prompts, plens


def phase_serve(dev) -> dict:
    from repro_torch import kernels as K
    from repro_torch.launch.serve import get_engine
    from repro_torch.nn import cache as KVC
    t0 = time.perf_counter()
    cfg, dbm, params, gen = build_model(dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for _, p in _leaves(params))
    say(f"[serve] {cfg.name}: {cfg.n_layers} layers d={cfg.d_model} "
        f"heads={cfg.n_heads} hd={cfg.head_dim} ff={cfg.d_ff} "
        f"vocab={cfg.vocab_size}, {dbm.num_blocks} blocks {dbm.ranges}; "
        f"{n_params / 1e9:.3f} B params fp32 made in "
        f"{time.perf_counter() - t0:.1f} s")
    prompts, plens = prompts_np(cfg.vocab_size)
    eng = get_engine(dbm, precision="bf16", chunk_size=CHUNK)
    # warm-up at the same shapes, 2 tokens (cuBLAS heuristics, allocator)
    eng.generate(params, prompts, 2, prompt_lengths=plens, generator=gen)
    eng.last_kv = None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.generate(params, prompts, MAX_NEW, prompt_lengths=plens,
                       generator=gen)
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    clocks = gpu_query("clocks.sm,power.draw,power.limit,temperature.gpu")
    tim = eng.last_timing
    gen_tok = _generated(out, plens)
    n_tok = BATCH * MAX_NEW
    pool_bytes = KVC.cache_bytes(eng.last_kv)
    L = cfg.n_layers
    expect = expected_counts(flash_decode=MAX_NEW * 2 * L,
                             gate_residual=MAX_NEW * 2 * L,
                             flash_prefill=-(-PROMPT // CHUNK) * L)
    decode_ms = tim["total_ms"] - tim["prefill_ms"]
    say(f"[serve] bf16, greedy, {BATCH} requests, prompts padded to {PROMPT} "
        f"(lengths {plens.tolist()}), chunk {CHUNK}, {MAX_NEW} new tokens")
    say(f"[serve] wall {wall:.3f} s | {n_tok / wall:.1f} tok/s | ttft "
        f"{tim['ttft_ms']:.1f} ms (prefill {tim['prefill_ms']:.1f} ms) | "
        f"decode {decode_ms / MAX_NEW:.2f} ms/step | peak memory "
        f"{peak / 2**30:.2f} GiB | cache {pool_bytes / 2**20:.1f} MiB | "
        f"nvidia-smi (sm MHz, W, limit, C): {clocks}")
    lb = serve_bounds(dbm, params, plens)
    say(f"[serve] bound from the shapes: prefill {lb['prefill_ms']:.2f} ms "
        f"({lb['prefill_by']}), decode {lb['decode_step_ms']:.2f} ms/step "
        f"({lb['decode_step_by']}); measured prefill "
        f"{tim['prefill_ms']:.1f} ms, decode {decode_ms / MAX_NEW:.2f} "
        f"ms/step")
    say(f"[serve] launches {counts} (expected {expect})")
    if counts != expect:
        raise SmokeError(f"launch counts {counts} != path arithmetic "
                         f"{expect}")
    if not ((gen_tok >= 0) & (gen_tok < cfg.vocab_size)).all():
        raise SmokeError("generated token outside the vocabulary")
    for name in ("k", "v"):
        if not torch.isfinite(getattr(eng.last_kv, name)[:, 1:].float()
                              ).all():
            raise SmokeError(f"non-finite {name} pages after serving")
    say(f"[serve] first request's generated tokens: "
        f"{gen_tok[0, :12].tolist()} ...")
    eng.last_kv = None
    return {"counts": counts, "wall_s": wall, "tok_s": n_tok / wall,
            "ttft_ms": tim["ttft_ms"], "prefill_ms": tim["prefill_ms"],
            "decode_ms_per_step": decode_ms / MAX_NEW,
            "peak_mem_bytes": peak, "cache_bytes": pool_bytes,
            "clocks": clocks, "bounds": lb, "model": (dbm, params, gen)}


def device_busy(fn, top: int = 6, host: bool = False):
    """Run fn() under torch.profiler: (wall ms under the profiler, summed
    device ms, the ``top`` kernels by device time as (ms, count, name)).
    One stream, so the sum is the device's busy time. Only the card's
    activity is traced unless ``host``: tracing the host's ops too slows
    the host, and so lengthens the wall that a busy share divides by. The
    raw events are summed as they come: ``key_averages`` would first build
    a Python event tree over all of them, minutes for a run of a million
    kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA] + (
        [ProfilerActivity.CPU] if host else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        ms, n = by_name.get(e.name(), (0.0, 0))
        by_name[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
    rows = sorted(((ms, n, name) for name, (ms, n) in by_name.items()),
                  reverse=True)
    return wall, sum(r[0] for r in rows), rows[:top]


def phase_profile(dev, model) -> dict:
    """Where a full-width bf16 step's time goes: device busy share of the
    prefill (8 chunks) and of 4 decode steps, and the top kernels. The
    decode is measured again with the host's ops traced too, as every
    busy share before PR 24 was, to relate the two denominators."""
    from repro_torch.launch.serve import get_engine
    from repro_torch.nn import cache as KVC
    dbm, params, gen = model
    prompts, plens = prompts_np(dbm.cfg.vocab_size)
    eng = get_engine(dbm, precision="bf16", chunk_size=CHUNK)
    pps = KVC.pages_for(PROMPT + MAX_NEW, PSZ)
    kv = dbm.model.init_paged_cache(BATCH, 1 + BATCH * pps, PSZ, eng.pol,
                                    device=dev)
    table = KVC.identity_page_table(BATCH, pps, device=dev)
    buf = torch.as_tensor(prompts, device=dev)
    pl = torch.as_tensor(plens, dtype=torch.int32, device=dev)
    state = {"lens": torch.zeros(BATCH, dtype=torch.int32, device=dev)}

    def prefill():
        _, state["lens"] = eng.run_prefill(params, kv, table, state["lens"],
                                           buf, pl)

    def decode():
        eng.decode(params, kv, table, state["lens"], pl + MAX_NEW, 4,
                   generator=gen)

    out = {}
    for name, fn, host in (("prefill, 8 chunks", prefill, False),
                           ("decode, 4 steps", decode, False),
                           ("decode, 4 steps, host traced", decode, True)):
        wall, busy, top = device_busy(fn, host=host)
        out[name] = {"wall_ms": wall, "device_ms": busy}
        if busy == 0:
            say(f"[profile] {name}: device time not measured (the profiler "
                "saw no kernels)")
            continue
        say(f"[profile] {name}: wall {wall:.1f} ms under the profiler, "
            f"device busy {busy:.1f} ms ({100 * busy / wall:.1f}%)")
        for ms, count, key in top:
            say(f"[profile]   {ms:8.2f} ms  x{count:<5d} {key[:90]}")
    return out


def serve_bounds(dbm, params, plens) -> dict:
    """Least device time of phase 4's run, from its shapes (larger of bytes
    over 3.35 TB/s and flops over the peak of their type). Prefill: each
    chunk reads the bf16 attention+MLP weights once and computes all
    B*C padded tokens (bf16 tensor-core flops). A decode step: 4 probes
    read every layer weight in fp32 (AdaLN heads included) plus the fp32
    head and σ-MLP; the commit reads the bf16 attention+MLP copy; both
    read every slot's committed K/V per layer (bf16); fp32 flops."""
    cfg, B, L = dbm.cfg, BATCH, dbm.cfg.n_layers
    layer_all = sum(t.numel() for _, t in _leaves(params["layers"]))
    commit = sum(t.numel() for p, t in _leaves(params["layers"])
                 if p[0] in ("attn", "mlp"))
    head = params["head"]["w"].numel()
    cond = sum(t.numel() for _, t in _leaves(params["cond"]))
    kv_row = 2 * cfg.n_kv_heads * cfg.head_dim * 2
    n_chunks = -(-PROMPT // CHUNK)
    pre = bound(n_chunks * commit * 2 + L * B * PROMPT * kv_row,
                2 * commit * B * n_chunks * CHUNK, PEAK_BF16)
    mean_len = float(sum(plens)) / B + (MAX_NEW - 1) / 2
    attn_flops = 2 * L * B * mean_len * cfg.n_heads * cfg.head_dim * 4
    dec = bound(layer_all * 4 + dbm.num_blocks * cond * 4 + head * 4
                + commit * 2 + 2 * L * B * mean_len * kv_row,
                2 * B * (layer_all + head + commit) + attn_flops, PEAK_FP32)
    return {"prefill_ms": pre[0], "prefill_by": pre[1],
            "decode_step_ms": dec[0], "decode_step_by": dec[1]}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _generated(out, plens):
    import numpy as np
    return torch.from_numpy(np.stack([out[b, p:p + MAX_NEW].numpy()
                                      for b, p in enumerate(plens)]))


def fp32_prefill(dev, model, impl: str, profiled: bool = False):
    """Phase 4's prompts prefilled into a fresh pool by the fp32 policy's
    engine through ``impl``: (kv, table, lengths, timing); with
    ``profiled``, timing holds the prefill's device busy ms and the ms of
    the paged-attention kernels in it (``rtk::``, the prefill kernels of any
    version of the port) under torch.profiler, else None."""
    from repro_torch.launch.serve import get_engine
    from repro_torch.nn import cache as KVC
    dbm, params, _ = model
    prompts, plens = prompts_np(dbm.cfg.vocab_size)
    eng = get_engine(dbm, precision="fp32", chunk_size=CHUNK, impl=impl)
    pps = KVC.pages_for(PROMPT + MAX_NEW, PSZ)
    kv = dbm.model.init_paged_cache(BATCH, 1 + BATCH * pps, PSZ, eng.pol,
                                    device=dev)
    table = KVC.identity_page_table(BATCH, pps, device=dev)
    state = {"lens": torch.zeros(BATCH, dtype=torch.int32, device=dev)}

    def run():
        _, state["lens"] = eng.run_prefill(
            params, kv, table, state["lens"], torch.as_tensor(prompts,
                                                              device=dev),
            torch.as_tensor(plens, dtype=torch.int32, device=dev))

    timing = None
    if profiled:
        wall, busy, rows = device_busy(run, top=None)
        timing = {"wall_ms": wall, "device_ms": busy,
                  "attention_ms": sum(ms for ms, _, key in rows
                                      if "rtk::" in key),
                  "attention_launches": sum(n for _, n, key in rows
                                            if "rtk::" in key)}
    else:
        run()
    return kv, table, state["lens"], timing


def phase_crosscheck(dev, model) -> dict:
    """The fp32 policy's prefill through the kernels (the 3xTF32 prefill
    route, timed under the profiler after a warm-up) and through the plain
    versions (``impl="ref"``), committed pools (pages 1 and up) within
    1e-3; then one fp32 serve step from the kernels' pool through both,
    logits within 1e-3."""
    from repro_torch import kernels as K
    dbm, params, gen = model
    fp32_prefill(dev, model, "kernels")                 # warm-up
    K.reset_launch_counts()
    kv, table, lengths, tim = fp32_prefill(dev, model, "kernels",
                                           profiled=True)
    counts = K.launch_counts()
    expect = expected_counts(flash_prefill=-(-PROMPT // CHUNK)
                             * dbm.cfg.n_layers)
    check_counts("fp32 prefill", counts, expect)
    kv_pre, _, lens_pre, _ = fp32_prefill(dev, model, "ref")
    # pages 1 and up: a chunk's padding entries write the trash page 0
    pre_rel = max(((getattr(kv, n)[:, 1:] - getattr(kv_pre, n)[:, 1:]).abs()
                   .max() / getattr(kv_pre, n)[:, 1:].abs().max()).item()
                  for n in ("k", "v"))
    say(f"[crosscheck] fp32 prefill ({-(-PROMPT // CHUNK)} chunks, "
        f"{counts['flash_prefill']} "
        f"prefill_tf32 launches), kernels vs plain versions: committed pool "
        f"rel max|diff| {pre_rel:.2e} (limit 1e-3) | device busy "
        f"{tim['device_ms']:.2f} ms of {tim['wall_ms']:.1f} ms under the "
        f"profiler, the prefill attention kernel {tim['attention_ms']:.2f} "
        f"ms in {tim['attention_launches']} launches")
    if not (pre_rel <= 1e-3 and math.isfinite(pre_rel)) or not torch.equal(
            lengths, lens_pre):
        raise SmokeError(f"fp32 prefill cross-check: pools differ by "
                         f"{pre_rel:.2e}")
    del kv_pre
    z0 = dbm.db.sigma_max * torch.randn((BATCH, 1, dbm.cfg.d_model),
                                        generator=gen, device=dev)
    kv_ref = kv.clone()
    out = {}
    for impl, pool in (("kernels", kv), ("ref", kv_ref)):
        tok, pool, _, logits = dbm.serve_step_paged(
            params, pool, table, lengths, z0=z0, precision="fp32", impl=impl,
            return_logits=True)
        out[impl] = (tok, pool, logits)
    lk, lr = out["kernels"][2], out["ref"][2]
    rel = ((lk - lr).abs().max() / lr.abs().max()).item()
    pool_rel = max(((getattr(out["kernels"][1], n)
                     - getattr(out["ref"][1], n)).abs().max()
                    / getattr(out["ref"][1], n).abs().max()).item()
                   for n in ("k", "v"))
    same = (out["kernels"][0] == out["ref"][0]).float().mean().item()
    say(f"[crosscheck] fp32 serve step, kernels vs plain versions: logits "
        f"rel max|diff| {rel:.2e} (limit 1e-3) | committed pool rel "
        f"max|diff| {pool_rel:.2e} | greedy tokens equal {same:.3f}")
    if not (rel <= 1e-3 and math.isfinite(rel)):
        raise SmokeError(f"fp32 cross-check: logits differ by {rel:.2e}")
    return {"logits_rel": rel, "pool_rel": pool_rel,
            "prefill_pool_rel": pre_rel, "prefill": tim}


def prefill_ref_bf16_p(q, k_pages, v_pages, page_table, lengths, *,
                       window=None, k_scale=None, v_scale=None):
    """The bf16 cross-check's control: ``flash_prefill_ref`` with P.V taken
    on bf16 P alone, as a tensor-core prefill that dropped P's lo term
    would take it (the row sum l keeps fp32 p)."""
    from repro_torch.kernels import flash_prefill as FP
    B, C, KV, G, hd = q.shape
    kk, vv = FP._gather_pages(k_pages, v_pages, page_table, k_scale, v_scale)
    s = torch.einsum("bckgd,bksd->bkgcs", q.float(), kk) / hd ** 0.5
    idx = torch.arange(kk.shape[2], device=q.device)
    qabs = lengths.long()[:, None] + torch.arange(C, device=q.device)
    valid = idx[None, None, :] <= qabs[:, :, None]
    if window is not None:
        valid &= idx[None, None, :] > qabs[:, :, None] - window
    valid = valid[:, None, None]
    s = torch.where(valid, s, torch.full_like(s, FP.NEG_INF))
    p = torch.where(valid, torch.exp(s - s.amax(-1, keepdim=True)),
                    torch.zeros_like(s))
    l = torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    out = torch.einsum("bkgcs,bksd->bkgcd", p.bfloat16().float(), vv) / l
    return out.permute(0, 3, 1, 2, 4)


def bf16_serve_run(dev, model, impl: str, seed: int, prefill=None):
    """Prefill seed's prompts into a fresh bf16 pool through ``impl`` (with
    ``prefill`` in place of the paged prefill attention, if given), then
    one greedy serve step from seed's z: (tokens, logits fp32, the live
    K and V pages after the prefill of the second unit of each block: the
    first pages a prefill output reaches, since each block's first unit
    starts from the embedding)."""
    from repro_torch.launch.serve import get_engine
    from repro_torch.nn import cache as KVC
    dbm, params, _ = model
    prompts, plens = prompts_np(dbm.cfg.vocab_size, seed)
    pps = KVC.pages_for(PROMPT + MAX_NEW, PSZ)
    table = KVC.identity_page_table(BATCH, pps, device=dev)
    gen = torch.Generator(device=dev).manual_seed(100 + seed)
    z0 = dbm.db.sigma_max * torch.randn((BATCH, 1, dbm.cfg.d_model),
                                        generator=gen, device=dev)
    eng = get_engine(dbm, precision="bf16", chunk_size=CHUNK, impl=impl)
    kv = dbm.model.init_paged_cache(BATCH, 1 + BATCH * pps, PSZ, eng.pol,
                                    device=dev)
    plain = KVC.flash_prefill
    KVC.flash_prefill = prefill or plain
    try:
        kv, lengths = eng.run_prefill(
            params, kv, table,
            torch.zeros(BATCH, dtype=torch.int32, device=dev),
            torch.as_tensor(prompts, device=dev),
            torch.as_tensor(plens, dtype=torch.int32, device=dev))
    finally:
        KVC.flash_prefill = plain
    units = [start + 1 for start, size in dbm.ranges if size > 1]
    pages = [getattr(kv, n)[units, 1:].float() for n in ("k", "v")]
    tok, _, _, logits = dbm.serve_step_paged(
        params, kv, table, lengths, z0=z0, precision="bf16", impl=impl,
        return_logits=True)
    return tok, logits.float(), pages


def bf16_gap(run, ref) -> dict:
    """``run`` against ``ref``: logits max|diff| / max|ref|, the reached
    pages' mean|diff| / mean|ref| (the larger of K and V), greedy
    agreement."""
    return {
        "logits_rel": ((run[1] - ref[1]).abs().max()
                       / ref[1].abs().max()).item(),
        "pages_rel": max(((a - b).abs().mean() / b.abs().mean()).item()
                         for a, b in zip(run[2], ref[2])),
        "greedy_equal": (run[0] == ref[0]).float().mean().item()}


def phase_crosscheck_bf16(dev, model) -> dict:
    """The bf16 serving path from the prompts on, for each of
    BF16_CROSS_SEEDS (prompts and z), each run prefilling its own pool and
    taking one serve step from the same z:
    * the whole path, kernels vs plain versions (``impl="ref"``): logits
      max|diff| / max|ref| within BF16_LOGITS_LIMIT. bf16 rounds the
      activations between the layers, so this reads the model's bf16
      noise, in which a prefill fault moves the reading by less than 2x;
    * the tensor-core prefill alone: kernels vs kernels with the plain
      prefill, on the pages the prefill outputs first reach (the second
      unit of each block): mean|diff| / mean|ref| within BF16_PAGES_LIMIT.
    The control is the kernels with the plain prefill on bf16 P alone (a
    prefill that dropped P's lo term) against the plain prefill, seed 0.
    Each limit sits between the largest sound reading and the control's
    (both recorded in PERF.md), and the control must exceed it in this run
    too, or the check could not see that fault."""
    from repro_torch.kernels import flash_prefill as FP
    sound = []
    for seed in BF16_CROSS_SEEDS:
        ref = bf16_serve_run(dev, model, "ref", seed)
        got = bf16_serve_run(dev, model, "kernels", seed)
        base = bf16_serve_run(dev, model, "kernels", seed,
                              prefill=FP.flash_prefill_ref)
        whole, alone = bf16_gap(got, ref), bf16_gap(got, base)
        sound.append({"whole": whole, "prefill": alone})
        say(f"[crosscheck] bf16 prefill + serve step, seed {seed}: whole "
            f"path, kernels vs plain versions: logits max|diff| / max|ref| "
            f"{whole['logits_rel']:.3e}, greedy tokens equal "
            f"{whole['greedy_equal']:.3f} | tensor-core prefill vs plain "
            f"prefill: reached pages mean|diff| / mean|ref| "
            f"{alone['pages_rel']:.3e}, logits {alone['logits_rel']:.3e}")
        if seed == BF16_CROSS_SEEDS[0]:
            control = bf16_gap(bf16_serve_run(
                dev, model, "kernels", seed, prefill=prefill_ref_bf16_p),
                base)
            say(f"[crosscheck] bf16 control, seed {seed}: plain prefill "
                f"with bf16 P alone vs plain prefill: reached pages "
                f"{control['pages_rel']:.3e}, logits "
                f"{control['logits_rel']:.3e}, greedy tokens equal "
                f"{control['greedy_equal']:.3f}")
        del ref, got, base
    for what, part, key, limit in (
            ("whole path: logits", "whole", "logits_rel", BF16_LOGITS_LIMIT),
            ("prefill alone: reached pages", "prefill", "pages_rel",
             BF16_PAGES_LIMIT)):
        worst = max(g[part][key] for g in sound)
        say(f"[crosscheck] bf16 {what}, largest of {len(sound)} seeds "
            f"{worst:.3e} <= limit {limit:.2e} < control "
            f"{control[key]:.3e}")
        if not (worst <= limit and math.isfinite(worst)):
            raise SmokeError(f"bf16 cross-check: {what} {worst:.3e} past "
                             f"its limit {limit:.2e}")
        if not control[key] > limit:
            raise SmokeError(f"bf16 cross-check: the control's {what} "
                             f"{control[key]:.3e} is within the limit "
                             f"{limit:.2e}; the check cannot see that fault")
    return {"sound": sound, "control": control}


# ---------------------------------------------------------------------------
# 5b. continuous batching
# ---------------------------------------------------------------------------

def cb_queue(vocab: int):
    """The continuous phase's traffic: CB_REQUESTS ``MarkovLM`` prompts
    from seed 1, ragged over CB_MIN-CB_MAX tokens, the even ones opening
    with one shared CB_SHARED-token prefix (a system prompt). Returns
    (prompts, lm)."""
    import numpy as np
    from repro_torch.data import MarkovLM
    lm = MarkovLM(vocab_size=vocab, seed=7)
    rs = np.random.RandomState(1)
    shared = lm.sample(rs, 1, CB_SHARED)[0]
    prompts = []
    for i in range(CB_REQUESTS):
        if i % 2 == 0:
            n = rs.randint(CB_SHARED + 1, CB_MAX + 1)
            prompts.append(np.concatenate(
                [shared, lm.sample(rs, 1, n - CB_SHARED)[0]]))
        else:
            prompts.append(lm.sample(rs, 1, rs.randint(CB_MIN,
                                                       CB_MAX + 1))[0])
    return prompts, lm


def cb_batcher(dev, model, *, precision="bf16", impl="kernels", graphs=True,
               total_pages=None, seed=0, num_slots=CB_SLOTS,
               prefix_cache=True, max_prompt=CB_MAX):
    from repro_torch.launch.serve import ContinuousBatcher
    dbm, params, _ = model
    return ContinuousBatcher(
        dbm, params, num_slots=num_slots, page_size=PSZ,
        max_prompt=max_prompt, max_len=max_prompt + CB_NEW, seg_len=CB_SEG,
        chunk_size=CHUNK,
        precision=precision, impl=impl, prefix_cache=prefix_cache,
        total_pages=total_pages, graphs=graphs,
        generator=torch.Generator(device=dev).manual_seed(seed))


def trie_holds(prefix) -> dict:
    """The page refs the prefix cache holds."""
    held = {}

    def walk(node):
        for child in node.children.values():
            held[child.page] = held.get(child.page, 0) + 1
            walk(child)
        for page, _ in node.tails:
            held[page] = held.get(page, 0) + 1

    for root in prefix.roots.values():
        walk(root)
    return held


def cb_drained(tag: str, cb, done, n: int) -> None:
    """Every request served in full, every page back: free pages and the
    prefix cache's own refs make the whole pool, and no slot holds one."""
    bad = [r.rid for r in done if len(r.out) != CB_NEW or r.error]
    if len(done) != n or bad:
        raise SmokeError(f"{tag}: {len(done)} of {n} requests finished, "
                         f"short or failed: {bad}")
    if cb.page_refs != trie_holds(cb.prefix) or (
            len(cb.free_pages) + len(cb.page_refs) != cb.total_pages - 1):
        raise SmokeError(f"{tag}: pages leaked: {len(cb.free_pages)} free, "
                         f"{len(cb.page_refs)} referenced of "
                         f"{cb.total_pages - 1}")


def paged_layers(dbm) -> tuple:
    """(layers over the paged pool, gate-residual launches of a probe
    pass): a dense model's every layer and its two σ-gates; the VLM's self
    layers only (its cross layers attend their image blocks in plain torch,
    ``cross_attend``) and two gates for each of its layers; the hybrid's
    shared-block applications (one a unit) and a gate for each Mamba layer
    and two for each application; the encoder-decoder's decoder layers and
    no gate kernel (it gates in plain ops, as JAX's does); the xLSTM's none
    and a gate for each of its blocks (one sLSTM and one mLSTM a unit)."""
    m = dbm.model
    if dbm.cfg.family == "ssm":                       # the xLSTM: no pages
        return 0, dbm.cfg.n_layers
    if hasattr(m, "inner"):                           # the hybrid
        return m.n_units, m.n_units * (m.inner + 2)
    if dbm.cfg.n_encoder_layers:                      # the encoder-decoder
        return dbm.cfg.n_layers, 0
    A = m.n_units * m.k_self if hasattr(m, "k_self") else dbm.cfg.n_layers
    return A, 2 * dbm.cfg.n_layers


def cb_counts(dbm, cb) -> dict:
    """Launches of a continuous run from its counters: per segment step a
    paged decode per self-attention layer in the probes and in the commit,
    and the probes' gate-residuals (``paged_layers``); per chunk dispatch a
    prefill per self-attention layer."""
    A, G = paged_layers(dbm)
    return expected_counts(flash_decode=2 * A * cb.steps,
                           gate_residual=G * cb.steps,
                           flash_prefill=A * cb.ingest_dispatches)


def cb_timed(cb) -> dict:
    """CUDA events around each decode segment and chunk dispatch of
    ``cb``, recorded on the stepping thread's stream. The wrappers reach
    ``cb`` through a weak reference: a bound method stored on the instance
    would make a cycle that keeps the batcher (its pool, graphs and their
    weight copy) allocated until a gc pass."""
    events = {"segment": [], "chunk": []}
    ref = weakref.ref(cb)

    def timed(kind, fn):
        def run(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(ref(), *args, **kw)
            end.record()
            events[kind].append((start, end))
            return out
        return run

    cls = type(cb)
    cb._decode_segment = timed("segment", cls._decode_segment)
    cb._chunk = timed("chunk", cls._chunk)
    return events


def cb_first_segments(dev, model, prompts, graphs: bool, n_seg: int,
                      profiled: bool = False):
    """Step a fresh batcher (graphs captured first) over the queue until
    ``n_seg`` segments ran, under the profiler if ``profiled``: (batcher,
    each request's tokens so far, the ms of its chunk dispatches,
    ``device_busy``'s result or None)."""
    cb = cb_batcher(dev, model, graphs=graphs)
    if graphs:
        cb.capture()
    events = cb_timed(cb)
    for p in prompts:
        cb.submit(p, CB_NEW)
    reqs = list(cb.queue)

    def steps():
        while cb.decode_dispatches < n_seg:
            cb.step()

    busy = device_busy(steps) if profiled else steps()
    torch.cuda.synchronize()
    return (cb, [list(r.out) for r in reqs],
            [s.elapsed_time(e) for s, e in events["chunk"]], busy)


def cb_logged(dev, model, prompts, precision, impl, n_seg=2, auxes=None):
    """Eager run of ``prompts`` (each with its ``auxes`` entry, where
    given) until ``n_seg`` segments ran, recording the readout's logits:
    (batcher, logits of each step (num_slots, vocab), emitted tokens
    (segments, num_slots, seg_len))."""
    import numpy as np
    dbm = model[0]
    cb = cb_batcher(dev, model, precision=precision, impl=impl,
                    graphs=False)
    logits, emitted = [], []
    plain, collect, ref = dbm.model.logits, type(cb)._collect, weakref.ref(cb)

    def readout(p, h):
        logits.append(plain(p, h))
        return logits[-1]

    def collected(e):             # ``cb`` weakly: no cycle (see cb_timed)
        emitted.append(e.copy())
        collect(ref(), e)

    dbm.model.logits, cb._collect = readout, collected
    try:
        for p, aux in zip(prompts, auxes or [None] * len(prompts)):
            cb.submit(p, CB_NEW, aux_inputs=aux)
        while cb.decode_dispatches < n_seg:
            cb.step()
    finally:
        del dbm.model.logits
    return cb, [x[:, 0].float() for x in logits], np.stack(emitted)


def phase_continuous(dev, model) -> dict:
    """Phase 5b: continuous batching of stablelm at full width (see the
    module docstring): the timed run, the graph against eager (its graphed
    run profiled), a pool under pressure, fp32 through the kernels against the
    plain versions, and bf16 / int8-pool agreement with fp32."""
    import numpy as np
    from repro_torch import kernels as K
    from repro_torch.launch.serve import _ragged_transition_accuracy
    dbm, params, _ = model
    t_phase = time.perf_counter()
    prompts, lm = cb_queue(dbm.cfg.vocab_size)
    cb = cb_batcher(dev, model)
    t0 = time.perf_counter()
    cb.capture()
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    events = cb_timed(cb)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    for p in prompts:
        cb.submit(p, CB_NEW)
    done = cb.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    clocks = gpu_query("clocks.sm,power.draw,power.limit,temperature.gpu")
    cb_drained("continuous", cb, done, CB_REQUESTS)
    check_counts("continuous", counts, cb_counts(dbm, cb))
    seg_ms = [s.elapsed_time(e) for s, e in events["segment"]]
    seg_step_ms = sum(seg_ms) / cb.steps
    chunk_ms = [s.elapsed_time(e) for s, e in events["chunk"]]
    # the share of the wall the card spent inside a dispatch (between its
    # events): an upper bound on the busy share, gaps inside a graph
    # included
    in_dispatch = (sum(seg_ms) + sum(chunk_ms)) / (wall * 1e3)
    ttft = sorted(r.ttft for r in done)
    n_tok = sum(len(r.out) for r in done)
    pool_mb = {k: round(v / 1e6, 1)
               for k, v in cb.kv_stats()["kv_bytes_by_dtype"].items()}
    rate = _ragged_transition_accuracy(
        lm, [np.concatenate([r.prompt, np.asarray(r.out)]) for r in done])
    say(f"[continuous] {CB_REQUESTS} requests on {CB_SLOTS} slots, bf16, "
        f"greedy, page {PSZ}, chunk {CHUNK}, seg_len {CB_SEG}, prefix cache "
        f"on, {CB_NEW} new tokens each; MarkovLM prompts {CB_MIN}-{CB_MAX} "
        f"tokens, half behind one {CB_SHARED}-token prefix; graph capture "
        f"{capture_s:.2f} s before the clock")
    say(f"[continuous] wall {wall:.3f} s | {n_tok / wall:.1f} tok/s | TTFT "
        f"median {statistics.median(ttft) * 1e3:.1f} ms, max "
        f"{ttft[-1] * 1e3:.1f} ms | decode {seg_step_ms:.3f} ms "
        f"per segment step ({len(seg_ms)} segments, median "
        f"{statistics.median(seg_ms) / CB_SEG:.3f}) | chunk dispatch "
        f"{statistics.median(chunk_ms):.2f} ms median, "
        f"{sum(chunk_ms) / len(chunk_ms):.2f} mean ({len(chunk_ms)}) | "
        f"inside a dispatch {100 * in_dispatch:.1f}% of the wall (CUDA "
        f"events) | nvidia-smi (sm MHz, W, limit, C): {clocks}")
    say(f"[continuous] dispatches {cb.ingest_dispatches} chunk + "
        f"{cb.decode_dispatches} segment ({cb.steps} segment steps) | "
        f"prefix hits {cb.prefix.hits}, shared tokens "
        f"{cb.prefix.tokens_shared} | CoW copies {cb.cow_copies} | pool "
        f"{cb.total_pages} pages, MB by dtype {pool_mb}"
        f" | legal-transition rate {rate:.4f} | launches {counts}")
    del cb, done
    torch.cuda.empty_cache()

    # the graph against eager: the first CB_CHECK_SEGMENTS segments of the
    # same schedule with the same draws; the graphed run is the profiled
    # window of the device-busy share
    runs = [cb_first_segments(dev, model, prompts, g, CB_CHECK_SEGMENTS,
                              profiled=g) for g in (True, False)]
    outs = [out for _, out, _, _ in runs]
    pools_equal = all(torch.equal(a[:, 1:], b[:, 1:]) for a, b in zip(
        *(pool_tensors(c.kv) for c, _, _, _ in runs)))
    say(f"[continuous] graph vs eager, first {CB_CHECK_SEGMENTS} segments: "
        f"emitted tokens {'identical' if outs[0] == outs[1] else 'DIFFER'} "
        f"({sum(map(len, outs[0]))} tokens), pools (pages 1 and up) "
        f"{'bit-equal' if pools_equal else 'DIFFER'} | chunk dispatch "
        f"median {statistics.median(runs[0][2]):.2f} ms graphed, "
        f"{statistics.median(runs[1][2]):.2f} ms eager "
        f"({len(runs[0][2])} each)")
    pwall, busy, top = runs[0][3]
    if busy == 0:
        say("[continuous] device busy: not measured (the profiler saw no "
            "kernels)")
    else:
        say(f"[continuous] profiled window (the graphed run's "
            f"{len(runs[0][2])} chunk and {CB_CHECK_SEGMENTS} segment "
            f"dispatches, admission included): wall {pwall:.1f} ms under "
            f"the profiler, device busy {busy:.1f} ms "
            f"({100 * busy / pwall:.1f}%)")
        for ms, count, key in top:
            say(f"[continuous]   {ms:8.2f} ms  x{count:<6d} {key[:90]}")
    if outs[0] != outs[1] or not pools_equal or not sum(map(len, outs[0])):
        raise SmokeError("continuous: the graph's segments differ from the "
                         "eager ones")
    del runs
    torch.cuda.empty_cache()

    # a pool at about 60% of the worst case, one request in four
    # interactive, submitted once the standard ones fill the slots
    worst = 1 + CB_SLOTS * (-(-(CB_MAX + CB_NEW) // PSZ)) + CB_SLOTS
    cb = cb_batcher(dev, model, total_pages=round(0.6 * worst))
    cb.capture()
    K.reset_launch_counts()
    late = [p for i, p in enumerate(prompts) if i % 4 == 3]
    for i, p in enumerate(prompts):
        if i % 4 != 3:
            cb.submit(p, CB_NEW)
    done = cb.step() + cb.step()
    for p in late:
        cb.submit(p, CB_NEW, priority="interactive")
    t0 = time.perf_counter()
    done += cb.run()
    torch.cuda.synchronize()
    pwall = time.perf_counter() - t0
    p_counts = K.launch_counts()
    cb_drained("pool under pressure", cb, done, CB_REQUESTS)
    check_counts("pool under pressure", p_counts, cb_counts(dbm, cb))
    inter = [r.ttft for r in done if r.priority == 2]
    say(f"[continuous] pool under pressure: {cb.total_pages} pages of "
        f"{worst} worst case, {len(late)} interactive submitted after 2 "
        f"steps: preemptions {cb.preemptions}, restores {cb.restores}, CoW "
        f"copies {cb.cow_copies}, every request complete, no page leaked | "
        f"wall {pwall:.2f} s after the arrivals, interactive TTFT median "
        f"{statistics.median(inter) * 1e3:.1f} ms")
    if cb.preemptions < 1 or cb.restores < 1:
        raise SmokeError("pool under pressure: no preemption and restore")
    add_counts(counts, p_counts)
    del cb, done
    torch.cuda.empty_cache()

    # fp32 through the kernels against the plain versions; bf16 and the
    # int8 pool against fp32, on the same schedule and draws
    few = prompts[:CB_SLOTS]
    K.reset_launch_counts()
    ck, lk, ek = cb_logged(dev, model, few, "fp32", "kernels")
    add_counts(counts, K.launch_counts())
    _, lr, er = cb_logged(dev, model, few, "fp32", "ref")
    first = ek[0] >= 0                          # (slots, seg_len) emitting
    diverged = [t for t in range(CB_SEG)
                if not np.array_equal(ek[0][:, t], er[0][:, t])]
    upto = diverged[0] + 1 if diverged else CB_SEG
    rel = max(((lk[t] - lr[t])[first[:, t]].abs().max()
               / lr[t][first[:, t]].abs().max()).item()
              for t in range(upto) if first[:, t].any())
    agree = float((ek == er)[ek >= 0].mean())
    say(f"[continuous] fp32, {len(few)} requests, 2 segments, kernels vs "
        f"plain versions: first segment's logits rel max|diff| {rel:.2e} "
        f"(limit 1e-3; steps 1-{upto}) | greedy tokens equal {agree:.4f} "
        f"over {int((ek >= 0).sum())}")
    if not (rel <= 1e-3 and math.isfinite(rel)):
        raise SmokeError(f"continuous fp32 cross-check: logits differ by "
                         f"{rel:.2e}")
    # each slot's first generated token follows its prompt alone, so it is
    # compared with fp32 on the same history; later tokens run free
    on = np.concatenate(list(ek >= 0), axis=1)          # (slots, steps)
    firsts = [(s, int(np.argmax(on[s]))) for s in range(len(on))
              if on[s].any()]
    agreement = {}
    for pol in ("bf16", "bf16_kvint8"):
        _, _, eq = cb_logged(dev, model, few, pol, "kernels")
        a, b = (np.concatenate(list(x), axis=1) for x in (eq, ek))
        agreement[pol] = {
            "first_token": float(np.mean([a[s, t] == b[s, t]
                                          for s, t in firsts])),
            "all": float((a == b)[on].mean())}
        say(f"[continuous] {pol} vs fp32, same schedule and draws: top-1 "
            f"agreement {agreement[pol]['first_token']:.4f} on each "
            f"request's first token ({len(firsts)} requests), "
            f"{agreement[pol]['all']:.4f} over 2 free-running segments "
            f"({int(on.sum())} tokens)")
    say(f"[continuous] phase 5b took {time.perf_counter() - t_phase:.1f} s")
    return {"counts": counts, "wall_s": wall, "tok_s": n_tok / wall,
            "ttft_median_s": statistics.median(ttft), "ttft_max_s": ttft[-1],
            "segment_step_ms": seg_step_ms, "in_dispatch": in_dispatch,
            "chunk_ms_median": statistics.median(chunk_ms),
            "logits_rel": rel, "agreement": agreement}


def pool_tensors(pkv):
    return [t for t in (pkv.k, pkv.v, pkv.k_scale, pkv.v_scale)
            if t is not None]


# ---------------------------------------------------------------------------
# 5c. the serving system: InferenceServer over the graphed batcher
# ---------------------------------------------------------------------------

def srv_trace(vocab: int, rate: float, bursty: bool, seed: int) -> list:
    """SRV_REQUESTS requests [(arrival s, prompt, max_new, class)]: Poisson
    arrivals at ``rate`` requests/s, or bursts of geometric size (mean
    SRV_BURST) arriving at rate / SRV_BURST; prompts clipped-lognormal in
    CB_MIN-CB_MAX tokens (median SRV_PROMPT), every fourth one behind the
    shared CB_SHARED-token prefix; new tokens clipped-lognormal in
    SRV_NEW (median 32); classes drawn from SRV_MIX."""
    import numpy as np
    from repro_torch.data import MarkovLM
    lm = MarkovLM(vocab_size=vocab, seed=7)
    rs = np.random.RandomState(seed)
    shared = lm.sample(rs, 1, CB_SHARED)[0]
    names, probs = zip(*SRV_MIX)
    out, t = [], 0.0
    while len(out) < SRV_REQUESTS:
        if bursty:
            t += rs.exponential(SRV_BURST / rate)
            k = int(rs.geometric(1.0 / SRV_BURST))
        else:
            t += rs.exponential(1.0 / rate)
            k = 1
        for _ in range(min(k, SRV_REQUESTS - len(out))):
            n = int(np.clip(round(SRV_PROMPT * np.exp(0.35 * rs.randn())),
                            CB_MIN, CB_MAX))
            new = int(np.clip(round(32 * np.exp(0.35 * rs.randn())),
                              *SRV_NEW))
            if len(out) % 4 == 0:
                n = max(n, CB_SHARED + 16)
                p = np.concatenate([shared,
                                    lm.sample(rs, 1, n - CB_SHARED)[0]])
            else:
                p = lm.sample(rs, 1, n)[0]
            out.append((t, p, new, str(rs.choice(names, p=probs))))
    return out


def srv_ledger(cb) -> tuple:
    """What a batcher's launches must be, from its counters: (paged
    layers, a probe pass's gates, segment steps and segment warm-ups, chunk
    dispatches and chunk warm-ups)."""
    return (*paged_layers(cb.dbm), cb.steps + cb.graph_warmups["segment"],
            cb.ingest_dispatches + cb.graph_warmups["chunk"])


def srv_counts(ledger) -> dict:
    """Launches of the batchers in ``ledger`` (see ``cb_counts``; a
    capture's eager warm-up step counts once)."""
    return expected_counts(
        flash_decode=sum(2 * A * seg for A, _, seg, _ in ledger),
        gate_residual=sum(G * seg for _, G, seg, _ in ledger),
        flash_prefill=sum(A * ch for A, _, _, ch in ledger))


async def srv_poll(want, what: str, timeout: float = 60.0) -> None:
    """Wait until ``want()`` holds (host state only)."""
    import asyncio
    t0 = time.monotonic()
    while not want():
        if time.monotonic() - t0 > timeout:
            raise SmokeError(f"server: {what} did not happen in {timeout} s")
        await asyncio.sleep(0.005)


async def srv_replay(port: int, trace, slos: bool = True) -> tuple:
    """Replay ``trace`` against the server on ``port`` with the port's
    client, each request at its arrival time (the interactive ones with
    their SLOs unless ``slos`` is off): (results, wall s)."""
    import asyncio
    from repro_torch.launch.server import stream_generate
    t0 = time.monotonic()

    async def one(at, prompt, new, cls):
        await asyncio.sleep(max(0.0, t0 + at - time.monotonic()))
        slo = ({"ttft_slo_ms": SRV_TTFT_SLO_MS, "tpot_slo_ms": SRV_TPOT_SLO_MS}
               if slos and cls == "interactive" else {})
        r = await stream_generate(SRV_HOST, port, prompt, new, priority=cls,
                                  **slo)
        r.update(cls=cls, max_new=new)
        return r

    results = await asyncio.gather(*(one(*x) for x in trace))
    return results, time.monotonic() - t0


def srv_report(tag: str, results, wall: float, counters: dict,
               in_dispatch: float) -> dict:
    """Print a trace's percentiles per class (client clock: TTFT from the
    request's send to its first token event; TPOT as the time from the
    first token event to the last over the tokens after the first event),
    sheds, deadline cancels, preemptions, SLO attainment per class (an
    interactive request attains when it finishes with TTFT and TPOT within
    its SLOs; a standard or batch one when it finishes), tok/s and the
    wall's share inside a dispatch."""
    import numpy as np
    no_hint = [r for r in results if r["status"] == 429
               and r["retry_after"] is None]
    bad = [r["status"] for r in results if r["status"] not in (200, 429)]
    if no_hint or bad:
        raise SmokeError(f"{tag}: {len(no_hint)} sheds without Retry-After, "
                         f"statuses {bad}")
    srv_complete(tag, [r for r in results if r["status"] == 200])
    out = {"classes": {}}
    for cls, _ in SRV_MIX:
        rows = [r for r in results if r["cls"] == cls]
        ttft, tpot, ok = [], [], 0
        for r in rows:
            if r["status"] != 200:
                continue
            times, counts = r["token_times"], r["token_counts"]
            t_ms = (times[0] - r["submit_t"]) * 1e3 if times else None
            p_ms = ((times[-1] - times[0]) * 1e3
                    / (len(r["ids"]) - counts[0])
                    if counts and len(r["ids"]) > counts[0] else None)
            if t_ms is not None:
                ttft.append(t_ms)
            if p_ms is not None:
                tpot.append(p_ms)
            done = "error" not in (r["final"] or {"error": 1})
            if done and (cls != "interactive" or (
                    t_ms <= SRV_TTFT_SLO_MS
                    and (p_ms is None or p_ms <= SRV_TPOT_SLO_MS))):
                ok += 1

        def pct(v, q):
            return f"{np.percentile(v, q):.1f}" if v else "n/a"
        shed = sum(r["status"] == 429 for r in rows)
        blown = sum(bool((r["final"] or {}).get("deadline_blown"))
                    for r in rows)
        out["classes"][cls] = {
            "n": len(rows), "attained": ok / max(len(rows), 1),
            "shed": shed, "deadline": blown,
            "ttft_p50": float(np.percentile(ttft, 50)) if ttft else None,
            "ttft_p99": float(np.percentile(ttft, 99)) if ttft else None}
        say(f"[server] {tag} {cls:11s}: {len(rows):2d} requests, SLO "
            f"attained {ok}/{len(rows)} | TTFT p50 {pct(ttft, 50)} p99 "
            f"{pct(ttft, 99)} ms | TPOT p50 {pct(tpot, 50)} p99 "
            f"{pct(tpot, 99)} ms ({len(tpot)} with 2+ token events) | "
            f"shed {shed}, deadline-cancelled {blown}")
    n_tok = sum(len(r["ids"]) for r in results)
    out.update(wall_s=wall, tok_s=n_tok / wall, in_dispatch=in_dispatch,
               **counters)
    say(f"[server] {tag}: wall {wall:.2f} s | {n_tok} tokens, "
        f"{n_tok / wall:.1f} tok/s | 429s {counters['shed']} (each with "
        f"Retry-After) | deadline cancels {counters['deadline_cancels']} | "
        f"preemptions {counters['preemptions']} | inside a dispatch "
        f"{100 * in_dispatch:.1f}% of the wall (CUDA events)")
    return out


def srv_complete(tag: str, results) -> None:
    """Each admitted request ended in a ``done`` event with its streamed
    tokens equal to the final output and exactly ``max_new`` of them, or
    in the ``error`` event of a deadline cancel (its partial output): any
    other end is a server or engine error."""
    for r in results:
        fin = r["final"] or {"error": "the stream ended with no final event"}
        if fin.get("deadline_blown") and r["ids"] == fin["ids"]:
            continue
        if ("error" in fin or r["ids"] != fin["ids"]
                or len(r["ids"]) != r["max_new"]):
            raise SmokeError(f"{tag}: a request ended with {len(r['ids'])} "
                             f"of {r['max_new']} tokens streamed, final "
                             f"{fin}")


def srv_runner(what: str, runner, crashes: int) -> None:
    """The engine thread's supervisor caught exactly ``crashes`` exceptions
    (the injected ``engine_crash`` the last of them) and is still serving:
    a recovered crash of any other kind fails the phase."""
    injected = "InjectedFault: injected fault 'engine_crash'"
    if (runner.crashes != crashes or runner.gave_up or runner.died
            or (crashes and not (runner.last_error or "").startswith(
                injected))):
        raise SmokeError(f"server, {what}: the engine thread caught "
                         f"{runner.crashes} exceptions (want {crashes}), "
                         f"last {runner.last_error!r}, gave up "
                         f"{runner.gave_up}, died {runner.died}")


def srv_crashed(results, new: int) -> None:
    """After the injected crash: each request finished with exactly its
    tokens, the streamed tokens equal to the final output (so what it had
    streamed before the crash is a prefix of it), and one of them spilled
    by the recovery."""
    for r in results:
        fin = r["final"] or {}
        if (r["status"] != 200 or "error" in fin or r["ids"] != fin["ids"]
                or len(r["ids"]) != new):
            raise SmokeError(f"crash recovery: a request lost or repeated "
                             f"tokens: status {r['status']}, streamed "
                             f"{len(r['ids'])}, final {fin}")
    if not any(r["final"]["preempted"] for r in results):
        raise SmokeError("crash recovery: no request was in a slot at the "
                         "crash")


async def srv_parity(make_cb, reqs) -> tuple:
    """The parity requests, one at a time, through a server over
    ``make_cb()`` (SSE), then the first one again as ``"stream": false``
    through a fresh one: (SSE tokens, the JSON ids, the batchers' launch
    ledgers, the first server's start s, its graph capture included)."""
    from repro_torch.launch.server import (InferenceServer, request_json,
                                           stream_generate)
    ledger, sse = [], []
    server = InferenceServer(make_cb())
    t0 = time.perf_counter()
    await server.start()
    start_s = time.perf_counter() - t0
    try:
        for p, n in reqs:
            r = await stream_generate(SRV_HOST, server.port, p, n)
            if r["status"] != 200:
                raise SmokeError(f"server parity: status {r['status']}, "
                                 f"final {r['final']}")
            srv_complete("server parity", [dict(r, max_new=n)])
            sse.append(r["ids"])
    finally:
        await server.aclose()
    srv_runner("parity", server.runner, 0)
    ledger.append(srv_ledger(server.cb))
    server = InferenceServer(make_cb())
    await server.start()
    try:
        code, obj = await request_json(
            SRV_HOST, server.port, "POST", "/v1/generate",
            {"prompt": [int(t) for t in reqs[0][0]], "max_new": reqs[0][1],
             "stream": False})
    finally:
        await server.aclose()
    srv_runner("parity", server.runner, 0)
    ledger.append(srv_ledger(server.cb))
    if code != 200:
        raise SmokeError(f"server parity: stream false answered {code}")
    return sse, obj["ids"], ledger, start_s


async def srv_load(cb, trace_a, trace_b, extra) -> dict:
    """Phase 5c's run on the full-width server over ``cb``: traces A and B,
    the faults, the drain. Returns the clients' results and the batcher's
    counters at each point (no device object)."""
    import asyncio
    from repro_torch.launch.faults import FaultInjector
    from repro_torch.launch.server import (InferenceServer, TokenStream,
                                           request_json, stream_generate)
    server = InferenceServer(cb)
    t0 = time.perf_counter()
    await server.start()
    out = {"capture_s": time.perf_counter() - t0, "marks": {}}
    port = server.port

    def mark(name):
        out["marks"][name] = (time.perf_counter(),
                              {k: getattr(cb, k) for k in (
                                  "shed_count", "deadline_cancels",
                                  "preemptions", "restores",
                                  "cancelled_count", "decode_dispatches",
                                  "ingest_dispatches")})

    def idle():
        return not cb.queue and not cb.active.any()

    try:
        mark("a0")
        out["a"] = await srv_replay(port, trace_a)
        await srv_poll(idle, "trace A's drain")
        mark("a1")
        cb.max_queue, cb.shed_below_pages = 8, cb.total_pages // 8
        out["b"] = await srv_replay(port, trace_b)
        await srv_poll(idle, "trace B's drain")
        mark("b1")
        cb.max_queue, cb.shed_below_pages = None, 0

        # faults: a mid-stream cancel, a closed connection, a slow consumer
        # of the bridge (cap 8 tokens: each 16-token segment pauses it)
        (p0, n0), (p1, n1), (p2, n2) = extra[:3]
        c0 = cb.cancelled_count
        r_cancel, r_abort = await asyncio.gather(
            stream_generate(SRV_HOST, port, p0, CB_NEW, cancel_after=16),
            stream_generate(SRV_HOST, port, p1, CB_NEW, abort_after=16))
        await srv_poll(lambda: cb.cancelled_count >= c0 + 2 and idle(),
                       "the cancel and the disconnect")
        pauses0 = server.backpressure_pauses
        rid = cb.submit(p2, CB_NEW)
        stream = TokenStream(asyncio.get_running_loop(), rid, 8,
                             on_pause=server._on_pause,
                             on_resume=server._on_resume)
        server.runner.attach(rid, stream)
        slow, done = [], False
        while not done:
            toks, done = await stream.next_batch()
            slow.extend(toks)
            await asyncio.sleep(0.2)
        out["faults"] = {"cancel": r_cancel, "abort": r_abort,
                         "slow": slow, "slow_req": stream.req.error,
                         "pauses": server.backpressure_pauses - pauses0}

        # an engine_crash while four requests stream, the first exception
        # the engine thread meets
        srv_runner("before the injected crash", server.runner, 0)
        restarts0 = server.runner.restarts
        d0 = cb.decode_dispatches
        tasks = [asyncio.ensure_future(stream_generate(
            SRV_HOST, port, p, CB_NEW)) for p, _ in extra[3:7]]
        await srv_poll(lambda: cb.decode_dispatches > d0,
                       "the crash requests' first segment")
        cb.faults = FaultInjector({"engine_crash": {"at": [2]}})
        crashed = await asyncio.gather(*tasks)
        cb.faults = None
        out["crash"] = {"results": crashed,
                        "restarts": server.runner.restarts - restarts0}

        # drain with requests in flight, then 503
        tasks = [asyncio.ensure_future(stream_generate(
            SRV_HOST, port, p, CB_NEW)) for p, _ in extra[7:13]]
        await srv_poll(lambda: cb.active.sum() + len(cb.queue) >= 6,
                       "the drain requests' admission")
        await server.drain()
        out["drained"] = await asyncio.gather(*tasks)
        out["after_drain"] = await request_json(
            SRV_HOST, port, "POST", "/v1/generate",
            {"prompt": [1, 2, 3], "max_new": 2}, return_headers=True)
        mark("end")
    finally:
        await server.aclose()
    srv_runner("after the drain", server.runner, 1)
    out["pool"] = (len(cb.free_pages), len(cb.page_refs),
                   cb.page_refs == trie_holds(cb.prefix), cb.total_pages,
                   bool(cb.active.any()))
    out["ledger"] = [srv_ledger(cb)]
    return out


def srv_share(events, lo, hi, wall: float) -> float:
    """The share of ``wall`` s spent inside the segment and chunk
    dispatches numbered ``lo`` to ``hi`` ((segments, chunks) each; CUDA
    events, read once the engine thread is gone)."""
    ms = sum(s.elapsed_time(e) for i, kind in enumerate(("segment", "chunk"))
             for s, e in events[kind][lo[i]:hi[i]])
    return ms / (wall * 1e3)


def clear_cublas_workspaces() -> None:
    """Free the cuBLAS workspaces PyTorch keeps per (handle, stream): each
    batcher's own stream and each engine thread's handle get one, which
    would count as allocated memory left behind."""
    getattr(torch._C, "_cuda_clearCublasWorkspaces", lambda: None)()


def phase_server(dev, model, continuous: dict) -> dict:
    """Phase 5c: the serving system (see the module docstring)."""
    import asyncio
    from repro_torch import kernels as K
    t_phase = time.perf_counter()
    clear_cublas_workspaces()
    base = torch.cuda.memory_allocated()
    K.reset_launch_counts()
    dbm = model[0]
    rate = CB_REQUESTS / continuous["wall_s"]
    trace_a = srv_trace(dbm.cfg.vocab_size, SRV_RATE_A * rate, False, 21)
    trace_b = srv_trace(dbm.cfg.vocab_size, SRV_RATE_B * rate, True, 22)
    extra = [(p, n) for _, p, n, _ in srv_trace(dbm.cfg.vocab_size, 1.0,
                                                 False, 23)]

    # 1. parity: a one-slot fp32 server at stablelm's widths, 4 layers,
    # against the direct step loop under the same generator seed
    small = (*runner_model(dev, 4, 4), None)
    reqs = [(extra[0][0], 24), (extra[1][0], 40)]

    def make_cb():
        return cb_batcher(dev, small, precision="fp32", seed=5, num_slots=1)

    cb = make_cb()
    t0 = time.perf_counter()
    cb.capture()
    capture_s = time.perf_counter() - t0
    direct = []
    for p, n in reqs:
        cb.submit(p, n)
        direct.append(cb.run()[0].out)
    ledger = [srv_ledger(cb)]
    del cb
    sse, json_ids, more, start_s = asyncio.run(srv_parity(make_cb, reqs))
    ledger += more
    del small
    say(f"[server] parity (one slot, fp32, stablelm widths with 4 layers, "
        f"graphs captured on the engine thread): SSE tokens of 2 requests "
        f"{'equal' if sse == direct else 'DIFFER from'} the direct step "
        f"loop's, bit for bit ({sum(map(len, sse))} tokens); stream false "
        f"{'equals' if json_ids == sse[0] else 'DIFFERS from'} its SSE twin"
        f" | capture {capture_s:.2f} s on the main thread, server start "
        f"{start_s:.2f} s (its capture on the engine thread)")
    if sse != direct or json_ids != sse[0]:
        raise SmokeError(f"server parity: SSE {sse} vs direct {direct}, "
                         f"JSON {json_ids}")

    # 2-4. the full-width server: traces A and B, faults, drain
    cb = cb_batcher(dev, model)
    events = cb_timed(cb)
    say(f"[server] {dbm.cfg.name} full width, bf16, {CB_SLOTS} slots, "
        f"seg_len {CB_SEG}, prefix cache on, graphs; phase 5b finished "
        f"{rate:.3f} requests/s: trace A Poisson at {SRV_RATE_A:.0%} "
        f"({SRV_RATE_A * rate:.3f}/s), trace B bursts of mean {SRV_BURST} "
        f"at {SRV_RATE_B:.0%} ({SRV_RATE_B * rate:.3f}/s, max_queue 8, "
        f"shed below {cb.total_pages // 8} free pages); {SRV_REQUESTS} "
        f"requests each, prompts {CB_MIN}-{CB_MAX} (median {SRV_PROMPT}), a "
        f"quarter behind one {CB_SHARED}-token prefix, {SRV_NEW[0]}-"
        f"{SRV_NEW[1]} new tokens (median 32), classes {dict(SRV_MIX)}, "
        f"interactive SLOs TTFT {SRV_TTFT_SLO_MS} ms, TPOT "
        f"{SRV_TPOT_SLO_MS} ms")
    run = asyncio.run(srv_load(cb, trace_a, trace_b, extra))
    ledger += run.pop("ledger")
    del cb
    torch.cuda.synchronize()
    marks = run["marks"]
    n_ev = {}          # dispatch index at each mark, per kind
    for k, (_, c) in marks.items():
        n_ev[k] = (c["decode_dispatches"], c["ingest_dispatches"])
    traces = {}
    for tag, lo, hi in (("trace A", "a0", "a1"), ("trace B", "a1", "b1")):
        results, wall = run["a" if tag == "trace A" else "b"]
        c0, c1 = marks[lo][1], marks[hi][1]
        counters = {k: c1[k] - c0[k] for k in (
            "shed_count", "deadline_cancels", "preemptions")}
        counters["shed"] = counters.pop("shed_count")
        share = srv_share(events, n_ev[lo], n_ev[hi],
                          marks[hi][0] - marks[lo][0])
        traces[tag] = srv_report(tag, results, wall, counters, share)
        if counters["shed"] != sum(r["status"] == 429 for r in results):
            raise SmokeError(f"{tag}: the batcher shed {counters['shed']}, "
                             "the clients saw another count of 429s")
    say(f"[server] graph capture on the engine thread {run['capture_s']:.2f}"
        f" s (before the server listened)")

    f = run["faults"]
    cancel, abort = f["cancel"], f["abort"]
    say(f"[server] faults: cancel after {len(cancel['ids'])} tokens "
        f"(cancelled {cancel['final']['cancelled']}), connection closed "
        f"after {len(abort['ids'])} tokens, slow consumer {len(f['slow'])} "
        f"of {CB_NEW} tokens with {f['pauses']} backpressure pauses | "
        f"engine_crash: restarts {run['crash']['restarts']}, "
        f"{len(run['crash']['results'])} requests streaming, preempted "
        f"{[r['final']['preempted'] for r in run['crash']['results']]}")
    if not (cancel["final"]["cancelled"] and len(cancel["ids"]) < CB_NEW
            and abort["aborted"]):
        raise SmokeError(f"server: cancel {cancel['final']}, abort "
                         f"{abort['aborted']}")
    if len(f["slow"]) != CB_NEW or f["slow_req"] or f["pauses"] < 1:
        raise SmokeError(f"server: slow consumer got {len(f['slow'])} "
                         f"tokens, {f['pauses']} pauses")
    if run["crash"]["restarts"] != 1:
        raise SmokeError(f"server: {run['crash']['restarts']} restarts "
                         "after one injected crash")
    srv_crashed(run["crash"]["results"], CB_NEW)

    code, obj, hdrs = run["after_drain"]
    free, held, trie_ok, total, active = run["pool"]
    short = [len(r["ids"]) for r in run["drained"] if len(r["ids"]) != CB_NEW]
    say(f"[server] drain: {len(run['drained'])} requests in flight all "
        f"complete ({'none short' if not short else short}), then "
        f"{code} ({obj.get('error')}, retry-after "
        f"{hdrs.get('retry-after')}) | pool: {free} free + {held} held by "
        f"the prefix cache = {free + held} of {total - 1}")
    if short or code != 503 or "retry-after" not in hdrs:
        raise SmokeError(f"server drain: short {short}, then {code}")
    srv_complete("server drain", [dict(r, max_new=CB_NEW)
                                  for r in run["drained"]])
    if free + held != total - 1 or not trie_ok or active:
        raise SmokeError(f"server: pool not whole after the drain: {free} "
                         f"free, {held} held, trie {trie_ok}")
    counts = K.launch_counts()
    check_counts("server", counts, srv_counts(ledger))
    clear_cublas_workspaces()
    after = torch.cuda.memory_allocated()
    say(f"[server] launches {counts} (the dispatches' arithmetic; per "
        f"batcher (layers, segment steps, chunk dispatches), warm-ups "
        f"included: {ledger}) | "
        f"memory allocated {base / 2**30:.2f} GiB before phase 5c, "
        f"{after / 2**30:.2f} GiB after its servers were dropped (no gc "
        f"pass; limit +0.5) | phase 5c took "
        f"{time.perf_counter() - t_phase:.1f} s")
    if after > base + SRV_MEM_SLACK:
        raise SmokeError(f"server: {(after - base) / 2**30:.2f} GiB still "
                         "allocated after the servers were dropped")
    return {"counts": counts, "traces": traces, "base_bytes": base,
            "after_bytes": after}


# ---------------------------------------------------------------------------
# 5d. disaggregated serving: InferenceServer over DisaggRouter
# ---------------------------------------------------------------------------

def dg_router(model, handoff, *, precision="bf16", num_slots=CB_SLOTS,
              n_decode=DG_DECODE, **kw):
    """A ``DisaggRouter`` of one prefill worker (prefix cache on) and
    ``n_decode`` decode workers over phase 5b's batcher shape."""
    from repro_torch.launch.router import DisaggRouter
    dbm, params, _ = model
    return DisaggRouter(
        dbm, params, n_prefill=1, n_decode=n_decode, handoff=handoff,
        num_slots=num_slots, page_size=PSZ, max_prompt=CB_MAX,
        max_len=CB_MAX + CB_NEW, seg_len=CB_SEG, chunk_size=CHUNK,
        precision=precision, prefix_cache=True, **kw)


def dg_collect(router) -> dict:
    """{rid: finished RoutedRequest}, filled by the router's finish
    callback."""
    done = {}
    router.finish_cb = lambda r: done.setdefault(r.rid, r)
    return done


def dg_wait(done: dict, rids, what: str, timeout: float = 120.0) -> None:
    t0 = time.monotonic()
    while not all(rid in done for rid in rids):
        if time.monotonic() - t0 > timeout:
            raise SmokeError(f"disagg: {what} did not finish in {timeout} s")
        time.sleep(0.002)


def dg_sequential(router, reqs) -> list:
    """``reqs`` [(prompt, max_new[, aux_inputs])] one at a time through
    ``router`` (started here, stopped after): each request's tokens."""
    done = dg_collect(router)
    router.start()
    outs = []
    try:
        for p, n, *aux in reqs:
            rid = router.submit(p, n, aux_inputs=aux[0] if aux else None)
            dg_wait(done, [rid], f"parity request {rid}")
            r = done[rid]
            if r.error or len(r.out) != n:
                raise SmokeError(f"disagg parity: request {rid} ended with "
                                 f"{len(r.out)} of {n} tokens, {r.error}")
            outs.append(list(r.out))
    finally:
        router.stop(60)
    return outs


def dg_whole(tag: str, router) -> str:
    """Every page of every pool free or held by a prefix cache, no slot
    active, no queue and no handoff left; one line saying so."""
    pools = ([(router.pool, router.workers)] if router.pool is not None
             else [(w.cb, [w]) for w in router.workers])
    lines = []
    for pool, workers in pools:
        held = {}
        for w in workers:
            if w.cb.prefix is not None:
                for page, n in trie_holds(w.cb.prefix).items():
                    held[page] = held.get(page, 0) + n
        free, refs = len(pool.free_pages), len(pool.page_refs)
        if (pool.page_refs != held or free + refs != pool.total_pages - 1
                or any(w.cb.active.any() or w.cb.queue for w in workers)):
            raise SmokeError(f"{tag}: pool not whole: {free} free, {refs} "
                             f"held of {pool.total_pages - 1}")
        lines.append(f"{free} free + {refs} held by the prefix cache = "
                     f"{free + refs} of {pool.total_pages - 1}")
    if router._handoffs:
        raise SmokeError(f"{tag}: {len(router._handoffs)} handoffs stranded")
    return "; ".join(lines)


def dg_share(events, lo, hi, wall: float) -> float:
    """The share of ``wall`` s inside the dispatches of every worker
    between two marks (``lo``, ``hi``: each worker's event counts by
    kind; CUDA events, read once the engine threads are gone). The pool
    lock serializes the workers, so the sum stays within the wall."""
    ms = sum(s.elapsed_time(e) for ev, a, b in zip(events, lo, hi)
             for kind in ("segment", "chunk")
             for s, e in ev[kind][a[kind]:b[kind]])
    return ms / (wall * 1e3)


async def dg_load(router, trace, events) -> dict:
    """Phase 5d's full-width run: trace A through ``InferenceServer`` over
    ``router``, then again with a decode worker's death, a dropped handoff
    and a stalled one injected and no SLOs (so every request must end with
    all its tokens). Returns the results and the counters at each mark."""
    import asyncio
    from repro_torch.launch.faults import FaultInjector
    from repro_torch.launch.server import InferenceServer
    server = InferenceServer(router)
    t0 = time.perf_counter()
    await server.start()
    out = {"start_s": time.perf_counter() - t0, "marks": {},
           "capture_s": list(router.capture_s)}
    names = ("migrations", "failovers", "handoff_retries", "handoff_drops",
             "re_prefills", "degradations", "resplits", "shed_count")

    def mark(name):
        per = [{k: getattr(w.cb, k) for k in (
            "deadline_cancels", "preemptions")} for w in router.workers]
        out["marks"][name] = (
            time.perf_counter(),
            [{k: len(v) for k, v in ev.items()} for ev in events],
            {**{k: getattr(router, k) for k in names},
             **{k: sum(c[k] for c in per) for k in per[0]}})

    def idle():
        st = router.stats()
        return not st["inflight"] and not st["pending_handoffs"]

    decode0 = router.decode_workers[0]
    out["warmups"] = [dict(w.cb.graph_warmups) for w in router.workers]
    try:
        mark("a0")
        out["a"] = await srv_replay(server.port, trace)
        await srv_poll(idle, "trace A's drain on the router")
        mark("a1")
        router.faults = FaultInjector({
            "handoff_drop": {"at": [DG_DROP_AT]},
            "handoff_stall": {"at": [DG_STALL_AT],
                              "sleep": (router.handoff_timeout_s
                                        + DG_STALL_OVER_S)}})
        # decode0 dies at its first step once half the run has finished
        half = router.completed + len(trace) // 2
        task = asyncio.ensure_future(srv_replay(server.port, trace,
                                                slos=False))
        await srv_poll(lambda: router.completed >= half or task.done(),
                       "half the fault run", timeout=300.0)
        decode0.cb.faults = FaultInjector({"worker_die": {"at": [1]}})
        out["f"] = await task
        await srv_poll(idle, "the fault run's drain on the router")
        await srv_poll(lambda: decode0.alive, "decode0's restart")
        mark("f1")
        router.faults = decode0.cb.faults = None
        out["decode0"] = (decode0.restarts, decode0.runner.died)
        out["health"] = server.stats()
    finally:
        await server.aclose()
    return out


def phase_disagg(dev, model, continuous: dict, server: dict) -> dict:
    """Phase 5d: disaggregated serving (see the module docstring)."""
    import asyncio
    from repro_torch import kernels as K
    from repro_torch.nn.cache import cache_bytes
    t_phase = time.perf_counter()
    clear_cublas_workspaces()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    dbm = model[0]
    rate = CB_REQUESTS / continuous["wall_s"]
    trace_a = srv_trace(dbm.cfg.vocab_size, SRV_RATE_A * rate, False, 21)
    extra = [(p, n) for _, p, n, _ in srv_trace(dbm.cfg.vocab_size, 1.0,
                                                 False, 23)]
    ledger = []

    # 1. parity: one-slot fp32 routers at stablelm's widths, 4 layers,
    # against the direct step loop under the same generator seed
    small = (*runner_model(dev, 4, 4), None)
    reqs = [(extra[0][0], 24), (extra[1][0], 40)]
    cb = cb_batcher(dev, small, precision="fp32", seed=5, num_slots=1)
    cb.capture()
    direct = []
    for p, n in reqs:
        cb.submit(p, n)
        direct.append(cb.run()[0].out)
    ledger.append(srv_ledger(cb))
    del cb
    parity = {}
    for handoff in ("copy", "pages"):
        router = dg_router(small, handoff, precision="fp32", num_slots=1,
                           n_decode=1)
        router.decode_workers[0].cb.generator.manual_seed(5)
        parity[handoff] = (dg_sequential(router, reqs), router.migrations)
        whole = dg_whole(f"disagg parity ({handoff})", router)
        ledger += [srv_ledger(w.cb) for w in router.workers]
        del router
    del small
    fp32 = srv_counts(ledger)
    say(f"[disagg] parity (one slot a worker, 1 prefill + 1 decode, fp32, "
        f"stablelm widths with 4 layers, graphs captured in the router's "
        f"start): copy {'equals' if parity['copy'][0] == direct else 'DIFFERS from'}"
        f" and pages {'equals' if parity['pages'][0] == direct else 'DIFFERS from'}"
        f" the direct step loop's tokens, bit for bit "
        f"({sum(map(len, direct))} tokens; migrations "
        f"{parity['copy'][1]}, {parity['pages'][1]}) | pool {whole} | fp32 "
        f"launches (direct loop and routers): prefill "
        f"{fp32['flash_prefill']}, decode {fp32['flash_decode']}")
    if any(parity[h][0] != direct for h in parity):
        raise SmokeError(f"disagg parity: copy {parity['copy'][0]}, pages "
                         f"{parity['pages'][0]}, direct {direct}")

    # 2-3. the full-width fleet over HTTP: trace A, then its fault run
    router = dg_router(model, "pages", restart_dead_after_s=DG_RESTART_S)
    events = [cb_timed(w.cb) for w in router.workers]
    say(f"[disagg] {dbm.cfg.name} full width, bf16, 1 prefill + "
        f"{DG_DECODE} decode workers of {CB_SLOTS} slots, handoff pages "
        f"on one shared pool of {router.pool.total_pages} pages "
        f"({cache_bytes(router.pool.kv) / 2**30:.2f} GiB), seg_len {CB_SEG}, "
        f"chunk {CHUNK}, prefix cache on the prefill worker; trace A as in "
        f"5c ({SRV_REQUESTS} requests, Poisson at {SRV_RATE_A * rate:.3f}/s,"
        f" seed 21)")
    run = asyncio.run(dg_load(router, trace_a, events))
    torch.cuda.synchronize()
    marks = run["marks"]
    shares = {(a, b): dg_share(events, marks[a][1], marks[b][1],
                               marks[b][0] - marks[a][0])
              for a, b in (("a0", "a1"), ("a1", "f1"))}
    whole = dg_whole("disagg", router)
    warmups = [dict(w.cb.graph_warmups) for w in router.workers]
    graphs = router.workers[0].cb.graphs
    ledger += [srv_ledger(w.cb) for w in router.workers]
    del router, events
    c0, c1 = marks["a0"][2], marks["a1"][2]
    results, wall = run["a"]
    rep = srv_report("disagg trace A", results, wall, {
        "shed": c1["shed_count"] - c0["shed_count"],
        "deadline_cancels": c1["deadline_cancels"] - c0["deadline_cancels"],
        "preemptions": c1["preemptions"] - c0["preemptions"]},
        shares["a0", "a1"])
    unified = server["traces"]["trace A"]
    say(f"[disagg] trace A beside 5c's unified server in this call: "
        + " | ".join(
            f"{cls} TTFT p50 {rep['classes'][cls]['ttft_p50'] or 0:.1f} "
            f"(unified {unified['classes'][cls]['ttft_p50'] or 0:.1f}) p99 "
            f"{rep['classes'][cls]['ttft_p99'] or 0:.1f} (unified "
            f"{unified['classes'][cls]['ttft_p99'] or 0:.1f}) ms"
            for cls, _ in SRV_MIX)
        + f" | tok/s {rep['tok_s']:.1f} (unified {unified['tok_s']:.1f}) | "
        f"inside a dispatch {100 * rep['in_dispatch']:.1f}% (unified "
        f"{100 * unified['in_dispatch']:.1f}%) | migrations "
        f"{c1['migrations'] - c0['migrations']} | server start "
        f"{run['start_s']:.2f} s (the workers' graphs captured on its "
        f"starting thread, one worker after another: "
        f"{', '.join(f'{s:.2f}' for s in run['capture_s'])} s)")
    # in split mode a request's tokens come from a decode worker: each
    # that streamed one migrated at least once
    streamed = sum(bool(r["ids"]) for r in results)
    if c1["migrations"] - c0["migrations"] < streamed:
        raise SmokeError(f"disagg: {c1['migrations'] - c0['migrations']} "
                         f"migrations for {streamed} requests that streamed")

    f1 = marks["f1"][2]
    got = {k: f1[k] - c1[k] for k in ("failovers", "handoff_drops",
                                      "handoff_retries", "re_prefills",
                                      "migrations")}
    fres, fwall = run["f"]
    bad = [(r["status"], len(r["ids"]), r["max_new"], (r["final"] or {})
            .get("error")) for r in fres
           if r["status"] != 200 or "error" in (r["final"] or {"error": 1})
           or r["ids"] != r["final"]["ids"] or len(r["ids"]) != r["max_new"]]
    n_tok = sum(len(r["ids"]) for r in fres)
    restarts, died = run["decode0"]
    say(f"[disagg] fault run (trace A again, no SLOs): decode0 killed at "
        f"its first step after half the run finished and restarted after "
        f"{DG_RESTART_S} s "
        f"(restarts {restarts}), handoff {DG_DROP_AT} dropped, handoff "
        f"{DG_STALL_AT} stalled {DG_STALL_OVER_S} s past the handoff "
        f"timeout | counters {got} | {len(fres) - len(bad)} of "
        f"{len(fres)} requests complete with all their tokens, {n_tok} "
        f"tokens in {fwall:.2f} s ({n_tok / fwall:.1f} tok/s) | inside a "
        f"dispatch {100 * shares['a1', 'f1']:.1f}% | pool "
        f"{whole} | graph warm-ups per worker {warmups} (one capture each, "
        f"none after the restart)")
    if (bad or got["failovers"] < 1 or got["handoff_drops"] != 1
            or got["handoff_retries"] < 1 or got["re_prefills"] < 1
            or restarts != 1 or died):
        raise SmokeError(f"disagg fault run: counters {got}, decode0 "
                         f"restarts {restarts} died {died}, short or failed "
                         f"requests {bad[:4]}")
    if warmups != run["warmups"] or any(
            w != {"chunk": 1, "segment": 1} for w in warmups if graphs):
        raise SmokeError(f"disagg: captures per worker {warmups}, "
                         f"{run['warmups']} at the start; want one chunk "
                         "and one segment graph each, none after the start")

    # 4. a short full-width copy run: separate pools, byte-copy migration
    router = dg_router(model, "copy", n_decode=1)
    done = dg_collect(router)
    t0 = time.perf_counter()
    router.start()
    start_s = time.perf_counter() - t0
    try:
        t0 = time.perf_counter()
        rids = [router.submit(p, n) for p, n in extra[:DG_COPY_REQUESTS]]
        dg_wait(done, rids, "the copy run")
        copy_s = time.perf_counter() - t0
    finally:
        router.stop(60)
    short = [(rid, len(done[rid].out), n, done[rid].error)
             for rid, (_, n) in zip(rids, extra) if done[rid].error
             or len(done[rid].out) != n]
    copy_whole = dg_whole("disagg copy", router)
    ledger += [srv_ledger(w.cb) for w in router.workers]
    copied = router.migrations
    del router, done
    say(f"[disagg] copy run (full width, 1 prefill + 1 decode, separate "
        f"pools): {DG_COPY_REQUESTS} requests at once, "
        f"{DG_COPY_REQUESTS - len(short)} complete, {copied} byte-copy "
        f"migrations, {copy_s:.2f} s (start {start_s:.2f} s) | pools "
        f"{copy_whole}")
    if short or copied != DG_COPY_REQUESTS:
        raise SmokeError(f"disagg copy run: short {short}, {copied} "
                         "migrations")

    counts = K.launch_counts()
    check_counts("disagg", counts, srv_counts(ledger))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    clear_cublas_workspaces()
    after = torch.cuda.memory_allocated()
    say(f"[disagg] launches {counts} (the dispatches' arithmetic over "
        f"{len(ledger)} batchers, warm-ups included) | memory allocated "
        f"{base / 2**30:.2f} GiB before phase 5d, peak "
        f"{peak / 2**30:.2f} GiB, {after / 2**30:.2f} GiB after its routers "
        f"were dropped (no gc pass; limit +0.1) | phase 5d took "
        f"{time.perf_counter() - t_phase:.1f} s")
    if after > base + DG_MEM_SLACK:
        raise SmokeError(f"disagg: {(after - base) / 2**30:.2f} GiB still "
                         "allocated after the routers were dropped")
    return {"counts": counts, "trace": rep, "peak_bytes": peak}


# ---------------------------------------------------------------------------
# 6. full-width training steps, 7. fp32 cross-check
# ---------------------------------------------------------------------------

def unit_digests(params, stack: str = "layers") -> torch.Tensor:
    """(n_units + 1,) int64: per unit an exact integer sum of the bits of
    its params in ``stack`` (any changed element changes it, short of a
    cancellation), and last the same over the rest (the periphery, and the
    hybrid's shared block)."""
    from repro_torch.nn.init import tree_items
    leaves = dict(tree_items(params))
    first = next(x for path, x in leaves.items() if path[0] == stack)
    L = first.shape[0]
    per_unit = torch.zeros(L, dtype=torch.int64, device=first.device)
    periphery = torch.zeros((), dtype=torch.int64, device=first.device)
    for path, x in leaves.items():
        bits = x.detach().view(torch.int32)
        if path[0] == stack:
            per_unit += bits.reshape(L, -1).sum(1, dtype=torch.int64)
        else:
            periphery += bits.sum(dtype=torch.int64)
    return torch.cat([per_unit, periphery[None]])


def timed_step(run):
    """(result, wall s, device ms between CUDA events, peak bytes, bytes
    allocated before) of run(); counts are reset just before it."""
    from repro_torch import kernels as K
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    start.record()
    out = run()
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (out, wall, start.elapsed_time(end),
            torch.cuda.max_memory_allocated(), base, K.launch_counts())


def profile_step(label, fn) -> dict:
    wall, busy, top = device_busy(fn, top=10)
    say(f"[profile] {label}: wall {wall:.1f} ms under the profiler, device "
        f"busy {busy:.1f} ms ({100 * busy / wall:.1f}%)")
    for ms, count, key in top:
        say(f"[profile]   {ms:8.2f} ms  x{count:<5d} {key[:90]}")
    return {"wall_ms": wall, "device_ms": busy}


def db_steps(dbm, params, gen, tcfg, data, tag: str) -> dict:
    """One bf16 DB step on each block, each with its block's own AdamW
    state, made before the step and freed after it (so the resident memory
    is what training that block alone holds: the masters and one block's
    moments), after a warm-up step (first-call costs: cuBLAS heuristics, the
    allocator growing); one more under the profiler; then one iteration of
    ``train_db``, which keeps every block's state resident as the training
    CLI does. Each run's launch counts must equal the path's arithmetic and
    only the trained block and the periphery may change."""
    from repro_torch.core import training as T
    cfg = dbm.cfg
    dev = params["embed"]["table"].device
    batch = lambda: torch.as_tensor(next(data), device=dev)  # noqa: E731

    def db_step(b, tokens):
        init, step = T.make_db_train_step(dbm, b, tcfg, precision="bf16")
        state = init(params)
        return lambda: step(params, state, tokens, gen)[2:]

    loss, _ = db_step(3, batch())()
    say(f"[{tag}] warm-up DB step on block 3: loss {float(loss):.4f}")
    out = {"db": [], "launches": {}}
    for b, (start, size) in enumerate(dbm.ranges):
        before = unit_digests(params)
        run = db_step(b, batch())
        (res, wall, dev_ms, peak, base, counts) = timed_step(run)
        loss, m = res
        # frees the block's AdamW state; the allocator keeps the blocks
        # cached (no cudaMalloc inside the next timed step)
        del run, res
        changed = (unit_digests(params) != before).tolist()
        expect = db_step_counts(dbm, size)
        say(f"[{tag}] DB step block {b} (units {start}-{start + size - 1}): "
            f"loss {float(loss):.4f} | grad norm {float(m['grad_norm']):.3f}"
            f" | wall {wall * 1e3:.1f} ms | device {dev_ms:.1f} ms (events) "
            f"| peak {peak / 2**30:.2f} GiB (resident before "
            f"{base / 2**30:.2f}: masters + this block's AdamW state) | "
            f"launches {counts}")
        if counts != expect:
            raise SmokeError(f"DB step block {b}: launch counts {counts} != "
                             f"path arithmetic {expect}")
        if not math.isfinite(float(loss)):
            raise SmokeError(f"DB step block {b}: loss {float(loss)}")
        want = [start <= u < start + size for u in range(cfg.n_layers)] \
            + [True]
        if changed != want:
            raise SmokeError(f"DB step block {b} changed units "
                             f"{changed} (expected {want})")
        add_counts(out["launches"], counts)
        out["db"].append({"block": b, "loss": float(loss), "wall_s": wall,
                          "device_ms": dev_ms, "peak_bytes": peak,
                          "resident_bytes": base})
    walls = [r["wall_s"] * 1e3 for r in out["db"]]
    say(f"[{tag}] DB step wall over the {len(walls)} blocks: median "
        f"{statistics.median(walls):.1f} ms, min-max {min(walls):.1f}-"
        f"{max(walls):.1f} ms")
    out["db_profile"] = profile_step(f"{tag}: DB step block 0",
                                     db_step(0, batch()))

    # the shipped trainer (``train_db``, what ``launch.train --mode db``
    # runs) makes every block's AdamW state up front and keeps them all:
    # one iteration of it, states made inside the timed region
    one = dataclasses.replace(tcfg, steps=1, log_every=0)
    (res, wall, dev_ms, peak, base, counts) = timed_step(
        lambda: T.train_db(dbm, one, data, gen, params=params,
                           precision="bf16")[1])
    (_, b, loss), = res
    del res
    torch.cuda.empty_cache()
    expect = db_step_counts(dbm, dbm.ranges[b][1])
    say(f"[{tag}] train_db, 1 iteration (block {b}, all "
        f"{dbm.num_blocks} AdamW states resident): loss {loss:.4f} | wall "
        f"{wall * 1e3:.1f} ms (states made inside) | peak "
        f"{peak / 2**30:.2f} GiB | launches {counts}")
    if counts != expect:
        raise SmokeError(f"train_db: launch counts {counts} != path "
                         f"arithmetic {expect}")
    if not math.isfinite(loss):
        raise SmokeError(f"train_db: loss {loss}")
    add_counts(out["launches"], counts)
    out["train_db"] = {"block": b, "loss": loss, "peak_bytes": peak}
    return out


def phase_train(dev, model) -> dict:
    """Phase 6. The serve phase's model (fp32 masters; its serving caches
    are dropped first), bf16 policy: ``db_steps``, then a warm-up e2e step,
    one timed and one under the profiler, every param's AdamW state
    resident."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import training as T
    from repro_torch.data import MarkovLM
    from repro_torch.launch.serve import ContinuousBatcher
    dbm, params, gen = model
    dbm.__dict__.pop("_compute_copies", None)     # serving's bf16 copy
    dbm.model.__dict__.pop("_unit_memo", None)
    torch.cuda.empty_cache()
    cfg = dbm.cfg
    tcfg = TrainConfig(steps=100, warmup_steps=10, lr=1e-4)
    data = MarkovLM(vocab_size=cfg.vocab_size, seed=7).iterator(
        TRAIN_BATCH, TRAIN_SEQ)
    batch = lambda: torch.as_tensor(next(data), device=dev)  # noqa: E731
    # what the serving phases left allocated: batchers kept only by
    # reference cycles (freed by no refcount, only by a gc pass) and
    # anything beyond the fp32 masters
    masters = sum(p.numel() * p.element_size() for _, p in _leaves(params))
    resident = torch.cuda.memory_allocated()
    stray = sum(isinstance(o, ContinuousBatcher) for o in gc.get_objects())
    say(f"[train] {cfg.name} full width, bf16 policy, MarkovLM batches "
        f"{TRAIN_BATCH}x{TRAIN_SEQ}; resident at the start "
        f"{resident / 2**30:.2f} GiB: fp32 masters "
        f"{masters / 2**30:.2f} GiB + {(resident - masters) / 2**30:.2f} "
        f"left by the serving phases ({stray} batchers still in memory; "
        f"phase 6 alone: 8.40 GiB, PR 25's p14.txt)")
    if resident - masters > 2**30 or stray:
        raise SmokeError(f"phase 6 starts with {(resident - masters) / 2**30:.2f}"
                         f" GiB beyond the masters and {stray} batchers "
                         "left by the serving phases")

    out = db_steps(dbm, params, gen, tcfg, data, "train")

    init, step = T.make_e2e_train_step(dbm, tcfg, precision="bf16")
    opt = init(params)
    loss = step(params, opt, batch())[2]
    say(f"[train] warm-up e2e step: loss {float(loss):.4f}")
    tokens = batch()
    (res, wall, dev_ms, peak, base, counts) = timed_step(
        lambda: step(params, opt, tokens)[2:])
    loss, m = res
    expect = expected_counts(**{n: cfg.n_layers for n in ATTN})
    say(f"[train] e2e step (all {cfg.n_layers} layers): loss "
        f"{float(loss):.4f} | grad norm {float(m['grad_norm']):.3f} | wall "
        f"{wall * 1e3:.1f} ms | device {dev_ms:.1f} ms (events) | peak "
        f"{peak / 2**30:.2f} GiB (resident before {base / 2**30:.2f}: "
        f"masters + AdamW state of every param) | launches {counts}")
    if counts != expect:
        raise SmokeError(f"e2e step: launch counts {counts} != path "
                         f"arithmetic {expect}")
    if not math.isfinite(float(loss)):
        raise SmokeError(f"e2e step: loss {float(loss)}")
    add_counts(out["launches"], counts)
    out["e2e"] = {"loss": float(loss), "wall_s": wall, "device_ms": dev_ms,
                  "peak_bytes": peak, "resident_bytes": base}
    tokens = batch()
    out["e2e_profile"] = profile_step("e2e step",
                                      lambda: step(params, opt, tokens))
    db_peak = max(r["peak_bytes"] for r in out["db"])
    all_peak = out["train_db"]["peak_bytes"]
    say(f"[train] peak memory: DB step with one block's AdamW state "
        f"{db_peak / 2**30:.2f} GiB ({db_peak / peak:.3f} of e2e), train_db "
        f"with all {dbm.num_blocks} states {all_peak / 2**30:.2f} GiB "
        f"({all_peak / peak:.3f} of e2e), e2e step "
        f"{peak / 2**30:.2f} GiB; nvidia-smi (sm MHz, "
        f"W, limit, C): "
        f"{gpu_query('clocks.sm,power.draw,power.limit,temperature.gpu')}")
    del opt
    torch.cuda.empty_cache()
    return out


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def block_crosscheck(params, view, make_step, args, kw, expect, tag: str,
                     grads, stack: str = "layers", whole=(),
                     limit: float = 1e-3) -> dict:
    """One fp32 step from the same params and draws (``step(params, state,
    *args, **kw)``), through the kernels and through their plain versions
    (``make_step(impl)`` for impl "kernels" and "ref"), on ``view`` =
    (start, size), the block of layers [start, start + size) and the
    periphery, or on every param when ``view`` is None; the trained params
    are restored between the two. Loss, grad norm and the first moments
    (0.1 x the clipped gradients) of the ``grads`` leaves (paths below
    ``stack``) of the first trained unit of ``stack`` and of the ``whole``
    leaves (paths from the root: an unstacked shared block), or of every
    trained leaf where ``grads`` is None, must agree to ``limit`` relative
    (a leaf: max |diff| over max |ref|), and the launches equal ``expect``
    (none for the plain path)."""
    from repro_torch import kernels as K
    from repro_torch.core import training as T
    from repro_torch.nn.init import tree_items, tree_map
    start, size = view or (0, None)
    saved = tree_map(lambda _, x: x.clone(), params if view is None
                     else T.extract_block_view(params, start, size))
    res = {}
    for impl in ("kernels", "ref"):
        init, step = make_step(impl)
        K.reset_launch_counts()
        _, opt, loss, m = step(params, init(params), *args, **kw)
        check_counts(f"{tag} cross-check impl={impl}", K.launch_counts(),
                     expect if impl == "kernels" else expected_counts())
        moments = ({g: x.clone() for g, x in tree_items(opt.mu)}
                   if grads is None else
                   {**{g: _at(opt.mu[stack], g)[0].clone() for g in grads},
                    **{g: _at(opt.mu, g).clone() for g in whole}})
        res[impl] = (float(loss), float(m["grad_norm"]), moments)
        del opt
        T.write_back_block_view(params, saved, start)
        torch.cuda.empty_cache()
    (lk, gk, mk), (lr, gr, mr) = res["kernels"], res["ref"]
    loss_rel, gn_rel = abs(lk - lr) / abs(lr), abs(gk - gr) / abs(gr)
    grad_rel = {"/".join(g): ((mk[g] - mr[g]).abs().max()
                              / mr[g].abs().max()).item() for g in mk}
    what = ("every param" if view is None
            else f"{'layers' if stack == 'core' else stack} {start}-"
            f"{start + size - 1}")
    if grads is None:
        worst = sorted(grad_rel.items(), key=lambda kv: -kv[1])[:3]
        shown = (f"every one of the {len(grad_rel)} trained leaves, grad "
                 "rel max|diff| worst " + ", ".join(
                     f"{k} {v:.2e}" for k, v in worst))
    else:
        shown = (f"{stack}[{start}] grad rel max|diff| " + ", ".join(
            f"{k} {v:.2e}" for k, v in grad_rel.items()))
    say(f"[crosscheck] {tag}: fp32 step on {what}, kernels vs plain "
        f"versions: loss {lk:.7f} vs {lr:.7f} (rel {loss_rel:.2e}) | grad "
        f"norm {gk:.7f} vs {gr:.7f} (rel {gn_rel:.2e}) | {shown}; limit "
        f"{limit:g}")
    if not (loss_rel <= limit and gn_rel <= limit
            and max(grad_rel.values()) <= limit):
        raise SmokeError(f"fp32 {tag} cross-check: kernels and plain "
                         "versions disagree")
    return {"loss_rel": loss_rel, "grad_norm_rel": gn_rel,
            "grad_rel": grad_rel}


def db_crosscheck(dev, model, tag: str, grads, stack: str = "layers",
                  whole=(), batch: int = TRAIN_BATCH, seq: int = TRAIN_SEQ,
                  aux=None, limit: float = 1e-3) -> dict:
    """``block_crosscheck`` of one DB step on block 0 of a
    ``DiffusionBlocksModel`` (``batch`` x ``seq`` random tokens, σ and ε
    from the generator; ``aux`` the step's ``aux_inputs``, where given)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import training as T
    dbm, params, gen = model
    start, size = dbm.ranges[0]
    tokens = torch.randint(0, dbm.cfg.vocab_size, (batch, seq),
                           generator=gen, device=dev)
    sigma = dbm.sample_block_sigma(gen, (batch, 1, 1), 0, device=dev)
    eps = torch.randn(batch, seq, dbm.cfg.d_model, generator=gen,
                      device=dev)
    tcfg = TrainConfig(steps=100, warmup_steps=10, lr=1e-4)
    kw = {"sigma": sigma, "eps": eps}
    if aux is not None:
        kw["aux_inputs"] = aux
    return block_crosscheck(
        params, (start, size),
        lambda impl: T.make_db_train_step(dbm, 0, tcfg, impl=impl,
                                          precision="fp32"),
        (tokens,), kw, db_step_counts(dbm, size), tag, grads, stack, whole,
        limit)


def phase_two_pass(dev) -> dict:
    """Phase 8: olmo-1b at full width trained as DiffusionBlocks in the
    two-pass mode with the l2 loss (bf16 policy), through ``db_steps``. The
    model is made here from seed 0 (AdaLN heads randomised so the σ
    conditioning and its kernels do real work)."""
    from repro_torch.configs import DBConfig, get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.blocks import DiffusionBlocksModel
    from repro_torch.data import MarkovLM
    t0 = time.perf_counter()
    cfg = get_config(TWO_PASS_ARCH)
    dbm = DiffusionBlocksModel(cfg, DBConfig(
        num_blocks=4, overlap_gamma=0.1, causal_mode="two_pass", loss="l2"))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = dbm.init(gen)
    for k in ("w", "b"):
        params["layers"]["adaln"][k].normal_(0.0, 0.02, generator=gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for _, p in _leaves(params))
    say(f"[two-pass] {cfg.name}: {cfg.n_layers} layers d={cfg.d_model} "
        f"heads={cfg.n_heads} hd={cfg.head_dim} ff={cfg.d_ff} "
        f"vocab={cfg.vocab_size} norm={cfg.norm}, {dbm.num_blocks} blocks "
        f"{dbm.ranges}, causal_mode=two_pass loss=l2; {n_params / 1e9:.3f} "
        f"B params fp32 made in {time.perf_counter() - t0:.1f} s; bf16 "
        f"policy, MarkovLM batches {TRAIN_BATCH}x{TRAIN_SEQ}; resident "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    tcfg = TrainConfig(steps=100, warmup_steps=10, lr=1e-4)
    data = MarkovLM(vocab_size=cfg.vocab_size, seed=7).iterator(
        TRAIN_BATCH, TRAIN_SEQ)
    out = db_steps(dbm, params, gen, tcfg, data, "two-pass")
    say(f"[two-pass] peak memory: DB step with one block's AdamW state "
        f"{max(r['peak_bytes'] for r in out['db']) / 2**30:.2f} GiB, "
        f"train_db with all {dbm.num_blocks} states "
        f"{out['train_db']['peak_bytes'] / 2**30:.2f} GiB; nvidia-smi (sm "
        f"MHz, W, limit, C): "
        f"{gpu_query('clocks.sm,power.draw,power.limit,temperature.gpu')}")
    torch.cuda.empty_cache()
    out["model"] = (dbm, params, gen)
    return out


# ---------------------------------------------------------------------------
# 10. DiT-S/2, 11. Huginn at full width
# ---------------------------------------------------------------------------

def adapter_steps(label, params, ranges, n_layers, make_db, make_e2e, batch,
                  counts) -> dict:
    """A warm-up DB step on block 0, one timed DB step on each block (its
    own AdamW state made before the step, freed after it), one more under
    the profiler; then a warm-up, a timed and a profiled e2e step (every
    param's state resident). ``make_db(b)`` / ``make_e2e()`` give (init,
    step) pairs, ``batch()`` a step's positional arguments, ``counts(size)``
    the launches of a step over ``size`` layers. Each timed step's launches
    must equal that arithmetic and its loss be finite; a DB step may change
    only its block's layers and the periphery."""
    out = {"db": [], "launches": {}}

    def db_run(b, args):
        init, step = make_db(b)
        state = init(params)
        return lambda: step(params, state, *args)[2:]

    loss, _ = db_run(0, batch())()
    say(f"[{label}] warm-up DB step on block 0: loss {float(loss):.4f}")
    for b, (start, size) in enumerate(ranges):
        before = unit_digests(params)
        run = db_run(b, batch())
        (res, wall, dev_ms, peak, base, got) = timed_step(run)
        loss, m = res
        del run, res
        changed = (unit_digests(params) != before).tolist()
        say(f"[{label}] DB step block {b} (layers {start}-{start + size - 1})"
            f": loss {float(loss):.4f} | grad norm "
            f"{float(m['grad_norm']):.3f} | wall {wall * 1e3:.1f} ms | "
            f"device {dev_ms:.1f} ms (events) | peak {peak / 2**30:.2f} GiB "
            f"(resident before {base / 2**30:.2f}) | launches {got}")
        check_counts(f"{label} DB step block {b}", got, counts(size))
        if not math.isfinite(float(loss)):
            raise SmokeError(f"{label} DB step block {b}: loss {float(loss)}")
        want = [start <= u < start + size for u in range(n_layers)] + [True]
        if changed != want:
            raise SmokeError(f"{label} DB step block {b} changed layers "
                             f"{changed} (expected {want})")
        add_counts(out["launches"], got)
        out["db"].append({"block": b, "loss": float(loss), "wall_s": wall,
                          "device_ms": dev_ms, "peak_bytes": peak})
    out["db_profile"] = profile_step(f"{label}: DB step block 0",
                                     db_run(0, batch()))

    init, step = make_e2e()
    opt = init(params)
    step(params, opt, *batch())
    args = batch()
    (res, wall, dev_ms, peak, base, got) = timed_step(
        lambda: step(params, opt, *args)[2:])
    loss, m = res
    say(f"[{label}] e2e step (all {n_layers} layers): loss {float(loss):.4f}"
        f" | grad norm {float(m['grad_norm']):.3f} | wall {wall * 1e3:.1f} "
        f"ms | device {dev_ms:.1f} ms (events) | peak {peak / 2**30:.2f} GiB "
        f"(resident before {base / 2**30:.2f}) | launches {got}")
    check_counts(f"{label} e2e step", got, counts(n_layers))
    if not math.isfinite(float(loss)):
        raise SmokeError(f"{label} e2e step: loss {float(loss)}")
    add_counts(out["launches"], got)
    out["e2e"] = {"loss": float(loss), "wall_s": wall, "device_ms": dev_ms,
                  "peak_bytes": peak}
    out["e2e_profile"] = profile_step(f"{label}: e2e step",
                                      lambda: step(params, opt, *args))
    del opt
    torch.cuda.empty_cache()
    return out


def logits_gap(label, got, ref) -> float:
    """max |got - ref| / max |ref|; raises past 1e-3."""
    rel = ((got - ref).abs().max() / ref.abs().max()).item()
    say(f"[crosscheck] {label}, kernels vs plain versions: logits rel "
        f"max|diff| {rel:.2e} (limit 1e-3)")
    if not (rel <= 1e-3 and math.isfinite(rel)):
        raise SmokeError(f"{label}: kernels and plain versions differ by "
                         f"{rel:.2e}")
    return rel


def dit_step_counts(size: int) -> dict:
    """Launches of one DiT training step over ``size`` layers: per layer one
    attention forward, dq and dk/dv (``full`` mask), two gate-residual
    forward and backward (the σ-gates, no ``cond_mask``); one EDM loss
    forward and backward."""
    return expected_counts(**{n: size for n in ATTN},
                           gate_residual=2 * size,
                           gate_residual_bwd=2 * size, edm_loss_fwd=1,
                           edm_loss_bwd=1)


def sample_counts(evals: int, steps: int) -> dict:
    """Launches of a DiT sampler run: per layer evaluation one attention
    forward and two gate-residual forwards; one Euler forward per step."""
    return expected_counts(flash_attention_fwd=evals,
                           gate_residual=2 * evals, euler_fwd=steps)


def phase_dit(dev) -> dict:
    """Phase 10: DiT-S/2 at full width, fp32, batch 256 of 256 tokens."""
    from repro_torch.configs import paper
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import dit as DIT
    from repro_torch.core import edm
    from repro_torch.core import partition as PT
    from repro_torch.data import MixtureImagesContinuous
    t0 = time.perf_counter()
    dit = DIT.DiTDiffusionBlocks(paper.DIT_S2, paper.DIT_DB,
                                 data_dim=DIT_DIM, n_tokens=DIT_TOKENS)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = dit.init(gen)
    # AdaLN heads and out_proj are zero at init: randomise them so the σ
    # conditioning, the gate kernels and F do real work
    for k in ("w", "b"):
        params["layers"]["adaln"][k].normal_(0.0, 0.02, generator=gen)
    params["out_proj"]["w"].normal_(0.0, 0.02, generator=gen)
    cfg = dit.cfg
    n_params = sum(p.numel() for _, p in _leaves(params))
    mix = MixtureImagesContinuous(n_tokens=DIT_TOKENS, dim=DIT_DIM,
                                  n_modes=4)
    data = mix.iterator(DIT_BATCH)

    def batch():
        return (torch.as_tensor(next(data)[0], device=dev), gen)
    tcfg = TrainConfig(steps=100, warmup_steps=10, lr=1e-4)
    say(f"[dit] {cfg.name}: {cfg.n_layers} layers d={cfg.d_model} "
        f"heads={cfg.n_heads} hd={cfg.head_dim} ff={cfg.d_ff} "
        f"norm={cfg.norm} mlp={cfg.mlp}, {dit.db.num_blocks} blocks "
        f"{dit.ranges}, loss={dit.db.loss}; {DIT_TOKENS} tokens of "
        f"{DIT_DIM} dims; {n_params / 1e6:.2f} M params fp32 made in "
        f"{time.perf_counter() - t0:.1f} s; fp32, MixtureImagesContinuous "
        f"batches of {DIT_BATCH}")

    out = adapter_steps("dit", params, dit.ranges, cfg.n_layers,
                        lambda b: DIT.make_db_step(dit, b, tcfg),
                        lambda: DIT.make_e2e_step(dit, tcfg), batch,
                        dit_step_counts)

    sched = PT.sampling_schedule(dit.db, DIT_STEPS)[:-1]
    per_block = [sum(PT.block_of_sigma(dit.db, float(s)) == b for s in sched)
                 for b in range(dit.db.num_blocks)]
    out["sample"] = {}
    for blockwise in (True, False):
        kind = "blockwise" if blockwise else "full stack"
        dit.sample(params, DIT_SAMPLES, 2, blockwise, generator=gen)
        (res, wall, dev_ms, peak, base, counts) = timed_step(
            lambda: dit.sample(params, DIT_SAMPLES, DIT_STEPS, blockwise,
                               generator=gen))
        z, evals = res
        want = (sum(n * s for n, (_, s) in zip(per_block, dit.ranges))
                if blockwise else DIT_STEPS * cfg.n_layers)
        if evals != want:
            raise SmokeError(f"DiT sampler ({kind}): {evals} layer "
                             f"evaluations, expected {want}")
        check_counts(f"DiT sampler ({kind})", counts,
                     sample_counts(evals, DIT_STEPS))
        if tuple(z.shape) != (DIT_SAMPLES, DIT_TOKENS, DIT_DIM) \
                or not torch.isfinite(z).all():
            raise SmokeError(f"DiT sampler ({kind}): samples not finite or "
                             f"of shape {tuple(z.shape)}")
        dist, cover = mix.fidelity(z.cpu().numpy())
        say(f"[dit] sample ({kind}), {DIT_SAMPLES} samples, {DIT_STEPS} "
            f"steps (per block {per_block}): {evals} layer evaluations | "
            f"wall {wall * 1e3:.1f} ms | device {dev_ms:.1f} ms (events) | "
            f"peak {peak / 2**30:.2f} GiB | fidelity (untrained weights, "
            f"sanity only): mean distance to nearest mode {dist:.3f}, mode "
            f"coverage {cover:.3f} | launches {counts}")
        add_counts(out["launches"], counts)
        out["sample"][kind] = {"evals": evals, "wall_s": wall,
                               "device_ms": dev_ms, "fidelity": (dist, cover)}
    bw, fs = out["sample"]["blockwise"], out["sample"]["full stack"]
    say(f"[dit] full stack / blockwise: wall {fs['wall_s'] / bw['wall_s']:.3f}"
        f"x, device {fs['device_ms'] / bw['device_ms']:.3f}x, layer "
        f"evaluations {fs['evals'] / bw['evals']:.3f}x ({fs['evals']} / "
        f"{bw['evals']})")

    # fp32 cross-check: one DB step on block 0 at the steps' batch, σ from
    # block 0's range as its steps draw it, kernels against impl="ref"
    y, _ = batch()
    sigma = edm.sample_sigma_in_qrange(gen, (DIT_BATCH, 1, 1), dit.db,
                                       *PT.block_qrange(dit.db, 0),
                                       device=dev)
    eps = torch.randn(y.shape, generator=gen, device=dev)
    out["crosscheck"] = block_crosscheck(
        params, dit.ranges[0], lambda impl: DIT.make_db_step(dit, 0, tcfg,
                                                             impl=impl),
        (y,), {"sigma": sigma, "eps": eps},
        dit_step_counts(dit.ranges[0][1]), "DiT-S/2",
        [("attn", "wq"), ("mlp", "wi"), ("adaln", "w")])
    del params
    torch.cuda.empty_cache()
    return out


def phase_huginn(dev) -> dict:
    """Phase 11: Huginn at full width, fp32, MarkovLM batches of 8 x 512."""
    from repro_torch.configs import paper
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import edm
    from repro_torch.core import partition as PT
    from repro_torch.core import recurrent as REC
    from repro_torch.data import MarkovLM
    t0 = time.perf_counter()
    m = REC.RecurrentDepthModel(paper.HUGINN, paper.HUGINN_DB,
                                prelude=paper.HUGINN_PRELUDE_LAYERS,
                                coda=paper.HUGINN_CODA_LAYERS,
                                recurrence=paper.HUGINN_RECURRENCE,
                                bptt_k=HUGINN_BPTT)
    cfg = m.cfg
    gen = torch.Generator(device=dev).manual_seed(0)
    params = m.init(gen)
    for k in ("w", "b"):
        params["core"]["adaln"][k].normal_(0.0, 0.02, generator=gen)
    n_params = sum(p.numel() for _, p in _leaves(params))
    data = MarkovLM(vocab_size=cfg.vocab_size, seed=7).iterator(
        TRAIN_BATCH, TRAIN_SEQ)
    batch = lambda: torch.as_tensor(next(data), device=dev)  # noqa: E731
    tcfg = TrainConfig(steps=100, warmup_steps=10, lr=1e-4)
    P_, C_, L_, K_ = (paper.HUGINN_PRELUDE_LAYERS, paper.HUGINN_CODA_LAYERS,
                      cfg.n_layers, m.K)
    say(f"[huginn] {cfg.name}: prelude {P_}, core {L_} x K={K_} (bptt_k "
        f"{m.bptt_k}), coda {C_}; d={cfg.d_model} heads={cfg.n_heads} "
        f"hd={cfg.head_dim} ff={cfg.d_ff} vocab={cfg.vocab_size} "
        f"norm={cfg.norm} mlp={cfg.mlp}; {n_params / 1e6:.2f} M params fp32 "
        f"made in {time.perf_counter() - t0:.1f} s; MarkovLM batches "
        f"{TRAIN_BATCH}x{TRAIN_SEQ}")
    fwd_k = P_ + K_ * L_ + C_
    bwd_k = P_ + m.bptt_k * L_ + C_
    expect = {"db_loss": expected_counts(**{n: P_ + L_ + C_ for n in ATTN}),
              "baseline_loss": expected_counts(
                  flash_attention_fwd=fwd_k, flash_attention_bwd_dq=bwd_k,
                  flash_attention_bwd_dkv=bwd_k)}
    out = {"launches": {}}
    for loss_name in ("db_loss", "baseline_loss"):
        init, step = REC.make_step(getattr(m, loss_name), tcfg)
        state = init(params)
        step(params, state, batch(), gen)
        tokens = batch()
        (res, wall, dev_ms, peak, base, counts) = timed_step(
            lambda: step(params, state, tokens, gen)[2:])
        loss, met = res
        say(f"[huginn] {loss_name} step: loss {float(loss):.4f} | grad norm "
            f"{float(met['grad_norm']):.3f} | wall {wall * 1e3:.1f} ms | "
            f"device {dev_ms:.1f} ms (events) | peak {peak / 2**30:.2f} GiB "
            f"(resident before {base / 2**30:.2f}) | launches {counts}")
        check_counts(f"Huginn {loss_name}", counts, expect[loss_name])
        if not math.isfinite(float(loss)):
            raise SmokeError(f"Huginn {loss_name}: loss {float(loss)}")
        add_counts(out["launches"], counts)
        out[loss_name] = {"loss": float(loss), "wall_s": wall,
                          "device_ms": dev_ms, "peak_bytes": peak}
        out[f"{loss_name}_profile"] = profile_step(
            f"Huginn {loss_name} step",
            lambda: step(params, state, tokens, gen))
        del state
        torch.cuda.empty_cache()
    base, db = out["baseline_loss"], out["db_loss"]
    say(f"[huginn] baseline / db step: wall "
        f"{base['wall_s'] / db['wall_s']:.2f}x, device "
        f"{base['device_ms'] / db['device_ms']:.2f}x")

    # fp32 cross-check of each step at 8 x 512, kernels against impl="ref"
    tokens = batch()
    shape = (TRAIN_BATCH, TRAIN_SEQ, cfg.d_model)
    q_lo, q_hi = (float(PT.q_of_sigma(s, m.db))
                  for s in (m.db.sigma_min, m.db.sigma_max))
    draws = {"db_loss": {
        "sigma": edm.sample_sigma_in_qrange(gen, (TRAIN_BATCH, 1, 1), m.db,
                                            q_lo, q_hi, device=dev),
        "eps": torch.randn(shape, generator=gen, device=dev)},
        "baseline_loss": {"s0": m.db.sigma_data * torch.randn(
            shape, generator=gen, device=dev)}}
    # the baseline runs the core unconditioned: its AdaLN gets no gradient
    grads = {"db_loss": [("attn", "wq"), ("mlp", "wg"), ("adaln", "w")],
             "baseline_loss": [("attn", "wq"), ("mlp", "wg")]}
    out["crosscheck"] = {name: block_crosscheck(
        params, None,
        lambda impl, name=name: REC.make_step(getattr(m, name), tcfg, impl),
        (tokens,), draws[name], expect[name], f"Huginn {name}", grads[name],
        stack="core") for name in ("db_loss", "baseline_loss")}

    tokens = batch()
    m.db_generate_logits(params, tokens, num_steps=2, generator=gen)
    z0 = m.db.sigma_max * torch.randn(TRAIN_BATCH, TRAIN_SEQ, cfg.d_model,
                                      generator=gen, device=dev)
    (logits, wall, dev_ms, peak, base, counts) = timed_step(
        lambda: m.db_generate_logits(params, tokens, z0=z0))
    check_counts("Huginn db_generate_logits", counts, expected_counts(
        flash_attention_fwd=fwd_k, euler_fwd=K_))
    if tuple(logits.shape) != (TRAIN_BATCH, TRAIN_SEQ, cfg.vocab_size) \
            or not torch.isfinite(logits).all():
        raise SmokeError("Huginn db_generate_logits: logits not finite or of "
                         f"shape {tuple(logits.shape)}")
    logp = torch.log_softmax(logits.float(), -1)
    ce = -torch.gather(logp, -1, tokens[..., None])[..., 0].mean().item()
    add_counts(out["launches"], counts)
    say(f"[huginn] db_generate_logits, {K_} Euler steps: wall "
        f"{wall * 1e3:.1f} ms | device {dev_ms:.1f} ms (events) | peak "
        f"{peak / 2**30:.2f} GiB | teacher-forced CE (untrained) {ce:.4f} | "
        f"launches {counts}")
    ref = m.db_generate_logits(params, tokens, z0=z0, impl="ref")
    rel = logits_gap(f"Huginn db_generate_logits, {K_} steps", logits, ref)
    out["generate"] = {"wall_s": wall, "device_ms": dev_ms, "ce": ce,
                       "logits_rel": rel}
    del params, logits, ref
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 12. ViT, 13. masked diffusion at full width
# ---------------------------------------------------------------------------

def vit_step_counts(size: int) -> dict:
    """Launches of one ViT training step over ``size`` layers: per layer
    one attention forward, dq and dk/dv (``full``, hd 32); the σ embedding
    modulates the label token only (``cond_mask``), so no AdaLN kernel."""
    return expected_counts(**{n: size for n in ATTN})


def phase_vit(dev) -> dict:
    """Phase 12: the ViT classifier (paper §5.1) at full width, fp32,
    ``GaussianMixtureImages`` batches of 128 32x32x3 images (100 classes,
    patch 4: 66 tokens)."""
    from repro_torch.configs import paper
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import edm
    from repro_torch.core import partition as PT
    from repro_torch.core import vit as VIT
    from repro_torch.data import GaussianMixtureImages
    t0 = time.perf_counter()
    vit = VIT.ViTDiffusionBlocks(paper.VIT_CIFAR, paper.VIT_DB)
    cfg = vit.cfg
    gen = torch.Generator(device=dev).manual_seed(0)
    params = vit.init(gen)
    # AdaLN heads are zero at init: randomise them so the σ conditioning of
    # the label token does real work
    for k in ("w", "b"):
        params["layers"]["adaln"][k].normal_(0.0, 0.02, generator=gen)
    n_params = sum(p.numel() for _, p in _leaves(params))
    data = GaussianMixtureImages(num_classes=vit.num_classes,
                                 image_size=vit.image_size).iterator(
        VIT_BATCH)

    def batch():
        x, y = next(data)
        return (torch.as_tensor(x, device=dev),
                torch.as_tensor(y, device=dev), gen)
    tcfg = TrainConfig(steps=100, warmup_steps=10, lr=1e-4)
    S = vit.n_patches + 2
    say(f"[vit] {cfg.name}: {cfg.n_layers} layers d={cfg.d_model} "
        f"heads={cfg.n_heads} hd={cfg.head_dim} ff={cfg.d_ff} "
        f"classes={vit.num_classes} norm={cfg.norm} mlp={cfg.mlp}, "
        f"{vit.db.num_blocks} blocks {vit.ranges}; {vit.image_size}x"
        f"{vit.image_size}x{vit.channels} images, patch {vit.patch}: {S} "
        f"tokens; {n_params / 1e6:.2f} M params fp32 made in "
        f"{time.perf_counter() - t0:.1f} s; fp32, GaussianMixtureImages "
        f"batches of {VIT_BATCH}")
    out = adapter_steps("vit", params, vit.ranges, cfg.n_layers,
                        lambda b: VIT.make_db_step(vit, b, tcfg),
                        lambda: VIT.make_e2e_step(vit, tcfg), batch,
                        vit_step_counts)

    x, y, _ = batch()
    vit.predict(params, x, 2, generator=gen)
    z0 = vit.db.sigma_max * torch.randn(VIT_BATCH, 1, cfg.d_model,
                                        generator=gen, device=dev)
    sched = PT.sampling_schedule(vit.db, VIT_STEPS)[:-1]
    evals = sum(vit.ranges[PT.block_of_sigma(vit.db, float(s))][1]
                for s in sched)
    ((pred, logits), wall, dev_ms, peak, base, got) = timed_step(
        lambda: vit.predict(params, x, VIT_STEPS, z0=z0))
    check_counts("ViT predict", got, expected_counts(
        flash_attention_fwd=evals, euler_fwd=VIT_STEPS))
    if tuple(logits.shape) != (VIT_BATCH, vit.num_classes) \
            or not torch.isfinite(logits).all():
        raise SmokeError("ViT predict: logits not finite or of shape "
                         f"{tuple(logits.shape)}")
    add_counts(out["launches"], got)
    acc = VIT.accuracy(pred, y.cpu())
    say(f"[vit] predict, {VIT_BATCH} images, {VIT_STEPS} Euler steps "
        f"({evals} layer evaluations): wall {wall * 1e3:.1f} ms | device "
        f"{dev_ms:.1f} ms (events) | peak {peak / 2**30:.2f} GiB | accuracy "
        f"after {vit.db.num_blocks + 2} DB and 3 e2e steps (sanity only) "
        f"{acc:.4f} | launches {got}")
    out["predict_profile"] = profile_step(
        "vit: predict", lambda: vit.predict(params, x, VIT_STEPS, z0=z0))
    ref = vit.predict(params, x, VIT_STEPS, z0=z0, impl="ref")[1]
    rel = logits_gap(f"ViT predict, {VIT_STEPS} steps", logits, ref)
    ((pred_e, logits_e), wall_e, dev_e, _, _, got) = timed_step(
        lambda: vit.predict_e2e(params, x))
    check_counts("ViT predict_e2e", got, expected_counts(
        flash_attention_fwd=cfg.n_layers))
    if not torch.isfinite(logits_e).all():
        raise SmokeError("ViT predict_e2e: logits not finite")
    add_counts(out["launches"], got)
    acc_e = VIT.accuracy(pred_e, y.cpu())
    say(f"[vit] predict_e2e, {VIT_BATCH} images ({cfg.n_layers} layers): "
        f"wall {wall_e * 1e3:.1f} ms | device {dev_e:.1f} ms (events) | "
        f"accuracy (sanity only) {acc_e:.4f} | launches {got}")
    out["predict"] = {"wall_s": wall, "device_ms": dev_ms, "evals": evals,
                      "accuracy": acc, "logits_rel": rel,
                      "e2e_accuracy": acc_e}

    # fp32 cross-check: one DB step on block 0, σ from block 0's range
    sigma = edm.sample_sigma_in_qrange(gen, (VIT_BATCH, 1, 1), vit.db,
                                       *PT.block_qrange(vit.db, 0),
                                       device=dev)
    eps = torch.randn(VIT_BATCH, 1, cfg.d_model, generator=gen, device=dev)
    out["crosscheck"] = block_crosscheck(
        params, vit.ranges[0], lambda impl: VIT.make_db_step(vit, 0, tcfg,
                                                             impl=impl),
        (x, y), {"sigma": sigma, "eps": eps},
        vit_step_counts(vit.ranges[0][1]), "ViT",
        [("attn", "wq"), ("mlp", "wi"), ("adaln", "w")])
    say(f"[vit] phase 12 took {time.perf_counter() - t0:.1f} s")
    del params
    torch.cuda.empty_cache()
    return out


def mdm_step_counts(size: int) -> dict:
    """Launches of one MDM training step over ``size`` layers: per layer one
    attention forward, dq and dk/dv (``full``, hd 64) and two gate-residual
    forwards and backwards (the t embedding on every position, no
    ``cond_mask``; the LayerNorm is parametric, so no ln-modulate)."""
    return expected_counts(**{n: size for n in ATTN},
                           gate_residual=2 * size,
                           gate_residual_bwd=2 * size)


def phase_mdm(dev) -> dict:
    """Phase 13: the masked-diffusion LM (paper §5.3) at full width, fp32,
    ``MarkovLM`` (31 symbols + [MASK]) batches of 64 x 256."""
    from repro_torch.configs import paper
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import masked as MASK
    from repro_torch.data import MarkovLM
    t0 = time.perf_counter()
    mdm = MASK.MaskedDiffusionBlocks(paper.MDM, paper.MDM_DB)
    cfg = mdm.cfg
    gen = torch.Generator(device=dev).manual_seed(0)
    params = mdm.init(gen)
    for k in ("w", "b"):
        params["layers"]["adaln"][k].normal_(0.0, 0.02, generator=gen)
    n_params = sum(p.numel() for _, p in _leaves(params))
    lm = MarkovLM(vocab_size=mdm.mask_id, seed=4)
    data = lm.iterator(MDM_BATCH, MDM_SEQ)

    def batch():
        return (torch.as_tensor(next(data), device=dev), gen)
    tcfg = TrainConfig(steps=100, warmup_steps=10, lr=1e-4)
    say(f"[mdm] {cfg.name}: {cfg.n_layers} layers d={cfg.d_model} "
        f"heads={cfg.n_heads} hd={cfg.head_dim} ff={cfg.d_ff} "
        f"vocab={cfg.vocab_size} ([MASK] {mdm.mask_id}) norm={cfg.norm} "
        f"mlp={cfg.mlp}, {mdm.db.num_blocks} blocks {mdm.ranges}; "
        f"{n_params / 1e6:.2f} M params fp32 made in "
        f"{time.perf_counter() - t0:.1f} s; MarkovLM batches "
        f"{MDM_BATCH}x{MDM_SEQ}")
    out = adapter_steps("mdm", params, mdm.ranges, cfg.n_layers,
                        lambda b: MASK.make_db_step(mdm, b, tcfg),
                        lambda: MASK.make_e2e_step(mdm, tcfg), batch,
                        mdm_step_counts)

    tokens, _ = batch()
    evals = sum(size for _, size in mdm.ranges)
    (bpc, wall, dev_ms, _, _, got) = timed_step(
        lambda: mdm.nelbo_bpc(params, tokens, gen, n_samples=2))
    check_counts("MDM nelbo_bpc", got, expected_counts(
        flash_attention_fwd=2 * evals, gate_residual=4 * evals))
    bpc = float(bpc)
    if not math.isfinite(bpc):
        raise SmokeError(f"MDM nelbo_bpc: {bpc}")
    add_counts(out["launches"], got)
    floor = -lm.log_likelihood(tokens.cpu().numpy())
    say(f"[mdm] nelbo_bpc, 2 samples x {mdm.db.num_blocks} blocks over "
        f"{MDM_BATCH}x{MDM_SEQ}: {bpc:.4f} bits/char after "
        f"{mdm.db.num_blocks + 2} DB and 3 e2e steps (sanity only; the "
        f"chain's entropy floor {floor:.4f}) | wall {wall * 1e3:.1f} ms | "
        f"device {dev_ms:.1f} ms (events) | launches {got}")

    n = mdm.db.num_sampling_steps
    times = MASK.sampler_times(n)
    gen_evals = sum(mdm.ranges[mdm.block_of_t(max(float(t), 1e-3))][1]
                    for t in times[:-1]) + mdm.ranges[-1][1]
    mdm.generate(params, MDM_GEN, MDM_SEQ, 2, generator=gen)
    (x, wall, dev_ms, peak, _, got) = timed_step(
        lambda: mdm.generate(params, MDM_GEN, MDM_SEQ, generator=gen))
    check_counts("MDM generate", got, expected_counts(
        flash_attention_fwd=gen_evals, gate_residual=2 * gen_evals))
    if tuple(x.shape) != (MDM_GEN, MDM_SEQ):
        raise SmokeError(f"MDM generate: tokens of shape {tuple(x.shape)}")
    add_counts(out["launches"], got)
    xs = x.cpu().numpy()
    left = int((xs == mdm.mask_id).sum())
    legal = (f"{lm.transition_accuracy(xs):.4f}" if left == 0
             else f"n/a ({left} [MASK] tokens sampled)")
    say(f"[mdm] generate {MDM_GEN}x{MDM_SEQ}, {n} steps + the final fill "
        f"({gen_evals} layer evaluations): wall {wall * 1e3:.1f} ms | device "
        f"{dev_ms:.1f} ms (events) | peak {peak / 2**30:.2f} GiB | legal "
        f"transitions (sanity only) {legal} | launches {got}")
    out["eval"] = {"bpc": bpc, "entropy_floor": floor,
                   "generate_wall_s": wall, "generate_device_ms": dev_ms}
    out["generate_profile"] = profile_step(
        "mdm: generate", lambda: mdm.generate(params, MDM_GEN, MDM_SEQ,
                                              generator=gen))

    # fp32 cross-check: one DB step on block 0, t from block 0's range
    lo, hi = mdm.t_range(0)
    t = lo + (hi - lo) * torch.rand(MDM_BATCH, 1, generator=gen, device=dev)
    u = torch.rand(MDM_BATCH, MDM_SEQ, generator=gen, device=dev)
    out["crosscheck"] = block_crosscheck(
        params, mdm.ranges[0], lambda impl: MASK.make_db_step(mdm, 0, tcfg,
                                                              impl=impl),
        (tokens,), {"t": t, "u": u}, mdm_step_counts(mdm.ranges[0][1]),
        "MDM", [("attn", "wq"), ("mlp", "wi"), ("adaln", "w")])
    say(f"[mdm] phase 13 took {time.perf_counter() - t0:.1f} s")
    del params
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------

SOURCES = {
    "flash_decode": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_decode.py:51"),
    "flash_prefill": ("src/repro_torch/kernels/csrc/flash_prefill.cu",
                      "src/repro/kernels/flash_prefill.py:52"),
    "gate_residual": ("src/repro_torch/kernels/csrc/gate_residual.cu",
                      "src/repro/kernels/fused_adaln.py:137"),
    "gate_residual_bwd": ("src/repro_torch/kernels/csrc/gate_residual.cu",
                          "src/repro/kernels/fused_adaln.py:143"),
    "ln_modulate_fwd": ("src/repro_torch/kernels/csrc/ln_modulate.cu",
                        "src/repro/kernels/fused_adaln.py:43"),
    "ln_modulate_bwd": ("src/repro_torch/kernels/csrc/ln_modulate.cu",
                        "src/repro/kernels/fused_adaln.py:53"),
    "edm_loss_fwd": ("src/repro_torch/kernels/csrc/edm_loss.cu",
                     "src/repro/kernels/edm_loss.py:41"),
    "edm_loss_bwd": ("src/repro_torch/kernels/csrc/edm_loss.cu",
                     "src/repro/kernels/edm_loss.py:58"),
    "euler_fwd": ("src/repro_torch/kernels/csrc/euler.cu",
                  "src/repro/kernels/fused_adaln.py:214"),
    "euler_bwd": ("src/repro_torch/kernels/csrc/euler.cu",
                  "src/repro/kernels/fused_adaln.py:221"),
    "flash_attention_fwd": (
        "src/repro_torch/kernels/csrc/flash_attention_fwd.cu",
        "src/repro/kernels/flash_attention.py:101"),
    "flash_attention_bwd_dq": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "src/repro/kernels/flash_attention.py:195"),
    "flash_attention_bwd_dkv": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "src/repro/kernels/flash_attention.py:228"),
}
# ---------------------------------------------------------------------------
# 14. the fault-tolerant training system: the block-parallel engine at full
#     width (14a), the TrainRunner with checkpoints and faults (14b)
# ---------------------------------------------------------------------------

def _clone(tree):
    from repro_torch.nn.init import tree_map
    return tree_map(lambda _, x: x.clone(), tree)


def _equal(a, b) -> bool:
    from repro_torch.nn.init import tree_items
    return all(torch.equal(x, y) for (_, x), (_, y) in
               zip(tree_items(a), tree_items(b)))


def _bits(tree) -> int:
    """An exact integer sum of a tree's bits (any changed element changes
    it, short of a cancellation)."""
    from repro_torch.nn.init import tree_items
    return int(sum(x.detach().view(torch.int32).sum(dtype=torch.int64)
                   for _, x in tree_items(tree)
                   if x.dtype == torch.float32))


def bp_batch_counts(dbm, active: int) -> dict:
    """Launches of one engine batch: each active block update is one DB
    step of its block (the engine's blocks are equal-sized)."""
    one = db_step_counts(dbm, dbm.ranges[0][1])
    return {n: c * active for n, c in one.items()}


def phase_block_parallel(dev, train) -> dict:
    """Phase 14a: ``BlockParallelTrainer`` (round-robin) at stablelm-1.6b
    full width and depth, 4 blocks of 6 layers, bf16 policy with fp32
    masters, ``MarkovStream`` 8 x 512 through ``HostDataLoader``,
    replicate+psum-mean: a warm-up batch, a timed batch (CUDA events, peak
    memory), a profiled batch (device-busy share) and a batch with a NaN
    injected into block 2's loss; launch counts of each block update equal
    to one DB step's."""
    from repro_torch import kernels as K
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import HostDataLoader, MarkovLM
    from repro_torch.parallel import BlockParallelTrainer
    t0 = time.perf_counter()
    cfg, dbm, params, gen = build_model(dev)
    tcfg = TrainConfig(steps=100, warmup_steps=10, lr=1e-4)
    tr = BlockParallelTrainer(dbm, tcfg, precision="bf16")
    B, u = tr.B, tr.u
    state = tr.init_state(params)
    data = HostDataLoader(MarkovLM(vocab_size=cfg.vocab_size, seed=7).stream(
        TRAIN_BATCH, TRAIN_SEQ), device=dev)
    torch.cuda.synchronize()
    say(f"[block-parallel] {cfg.name} full width, {B} blocks of {u} layers, "
        f"bf16 policy, {tr.policy}, MarkovStream {TRAIN_BATCH}x{TRAIN_SEQ} "
        f"through HostDataLoader; masters + every block's and the "
        f"periphery's AdamW state resident: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB (made in "
        f"{time.perf_counter() - t0:.1f} s)")
    expect = bp_batch_counts(dbm, B)
    out = {"launches": {}}
    try:
        state, losses, _ = tr.step(state, next(data), gen)
        say(f"[block-parallel] warm-up batch: losses "
            f"{[round(float(x), 4) for x in losses]}")
        tokens = next(data)
        (res, wall, dev_ms, peak, base, counts) = timed_step(
            lambda: tr.step(state, tokens, gen))
        state, losses, gnorms = res
        check_counts("block-parallel batch", counts, expect)
        if not torch.isfinite(losses).all():
            raise SmokeError(f"block-parallel batch: losses {losses}")
        add_counts(out["launches"], counts)
        db_wall = statistics.median(r["wall_s"] for r in train["db"]) * 1e3
        say(f"[block-parallel] batch ({B} block updates): losses "
            f"{[round(float(x), 4) for x in losses]} | grad norms "
            f"{[round(float(x), 3) for x in gnorms]} | wall "
            f"{wall * 1e3:.1f} ms ({wall * 1e3 / B:.1f} ms per block update;"
            f" phase 6's DB step {db_wall:.1f} ms) | device {dev_ms:.1f} ms "
            f"(events) | peak {peak / 2**30:.2f} GiB (resident before "
            f"{base / 2**30:.2f}) | launches {counts}")
        tokens = next(data)
        wall_p, busy, top = device_busy(lambda: tr.step(state, tokens, gen),
                                        top=8)
        say(f"[profile] block-parallel batch: wall {wall_p:.1f} ms under the "
            f"profiler, device busy {busy:.1f} ms "
            f"({100 * busy / wall_p:.1f}%)")
        for ms, count, key in top:
            say(f"[profile]   {ms:8.2f} ms  x{count:<5d} {key[:90]}")

        # grad_nan on block 2: its stack, moments and step counter stay
        # bit-unchanged, the others and the periphery move
        victim = 2
        stack_v, opt_v = tr.block_trees(state, victim)
        kept = (_clone(stack_v), _clone(opt_v.mu), _clone(opt_v.nu),
                int(opt_v.step))
        others = [_bits(tr.block_trees(state, b)[0]) for b in range(B)]
        steps0 = state.stack_opt.step.tolist()
        periph0, pstep0 = _bits(state.periph), int(state.periph_opt.step)
        mult = [1.0] * B
        mult[victim] = float("nan")
        tokens = next(data)
        K.reset_launch_counts()
        state, losses, _ = tr.step(state, tokens, gen, loss_mult=mult)
        torch.cuda.synchronize()
        counts = K.launch_counts()
        check_counts("block-parallel grad_nan batch", counts, expect)
        add_counts(out["launches"], counts)
        stack_v, opt_v = tr.block_trees(state, victim)
        moved = [_bits(tr.block_trees(state, b)[0]) != others[b]
                 for b in range(B)]
        ok = (tr.last_ok.tolist() == [b != victim for b in range(B)]
              and _equal(stack_v, kept[0]) and _equal(opt_v.mu, kept[1])
              and _equal(opt_v.nu, kept[2]) and int(opt_v.step) == kept[3]
              and moved == [b != victim for b in range(B)]
              and state.stack_opt.step.tolist()
              == [s + (b != victim) for b, s in enumerate(steps0)]
              and _bits(state.periph) != periph0
              and int(state.periph_opt.step) == pstep0 + 1)
        say(f"[block-parallel] grad_nan on block {victim}: losses "
            f"{[round(float(x), 4) for x in losses]} | last_ok "
            f"{tr.last_ok.tolist()} | block {victim} stack, moments and step "
            f"counter bit-unchanged: {_equal(stack_v, kept[0])}, "
            f"{_equal(opt_v.mu, kept[1]) and _equal(opt_v.nu, kept[2])}, "
            f"{int(opt_v.step)} == {kept[3]} | blocks moved {moved} | step "
            f"counters {state.stack_opt.step.tolist()} | periphery moved: "
            f"{_bits(state.periph) != periph0} (step {pstep0} -> "
            f"{int(state.periph_opt.step)})")
        if not ok:
            raise SmokeError("block-parallel grad_nan: the guard did not "
                             "skip exactly the victim block")
        del kept
    finally:
        data.close()
    say(f"[block-parallel] peak memory: engine batch {peak / 2**30:.2f} GiB "
        f"vs phase 6's train_db {train['train_db']['peak_bytes'] / 2**30:.2f}"
        f" GiB and e2e step {train['e2e']['peak_bytes'] / 2**30:.2f} GiB; "
        f"nvidia-smi (sm MHz, W, limit, C): "
        f"{gpu_query('clocks.sm,power.draw,power.limit,temperature.gpu')}")
    out.update(wall_s=wall, device_ms=dev_ms, peak_bytes=peak,
               busy_share=busy / wall_p)
    del state, tr, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def runner_model(dev, n_layers: int, blocks: int, cut=None):
    """stablelm-1.6b's widths and vocabulary (or ``cut``'s, a dict of
    config fields such as ``RUNNER_CUT``) with ``n_layers`` layers in
    ``blocks`` blocks, random weights from seed 0 (AdaLN heads
    randomised)."""
    from repro_torch.configs import DBConfig, get_config
    from repro_torch.core.blocks import DiffusionBlocksModel
    cfg = dataclasses.replace(get_config(ARCH), n_layers=n_layers,
                              **(cut or {}))
    dbm = DiffusionBlocksModel(cfg, DBConfig(num_blocks=blocks,
                                             overlap_gamma=0.1))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = dbm.init(gen)
    for k in ("w", "b"):
        params["layers"]["adaln"][k].normal_(0.0, 0.02, generator=gen)
    return dbm, params


def phase_block_parallel_crosscheck(dev) -> dict:
    """Phase 14a's fp32 batch at reduced depth (stablelm widths, 4 layers,
    4 blocks of 1) through the kernels against ``impl="ref"``, from the same
    params and draws: per-block losses within 1e-3 relative, every updated
    param within 1e-3, the first block's attention first moments within
    1e-3 of their largest."""
    from repro_torch import kernels as K
    from repro_torch.configs.base import TrainConfig
    from repro_torch.nn.init import tree_items
    from repro_torch.parallel import BlockParallelTrainer
    dbm, master = runner_model(dev, 4, 4)
    gen = torch.Generator(device=dev).manual_seed(5)
    Bsz = TRAIN_BATCH // 2
    tokens = torch.randint(0, dbm.cfg.vocab_size, (Bsz, TRAIN_SEQ),
                           generator=gen, device=dev)
    draws = [(dbm.sample_block_sigma(gen, (Bsz, 1, 1), b, device=dev),
              torch.randn(Bsz, TRAIN_SEQ, dbm.cfg.d_model, generator=gen,
                          device=dev)) for b in range(dbm.num_blocks)]
    tcfg = TrainConfig(steps=100, warmup_steps=10, lr=1e-4)
    res = {}
    for impl in ("kernels", "ref"):
        params = _clone(master)
        tr = BlockParallelTrainer(dbm, tcfg, impl=impl, precision="fp32")
        K.reset_launch_counts()
        state, losses, _ = tr.step(tr.init_state(params), tokens,
                                   draws=draws)
        torch.cuda.synchronize()
        check_counts(f"block-parallel cross-check impl={impl}",
                     K.launch_counts(), bp_batch_counts(dbm, dbm.num_blocks)
                     if impl == "kernels" else expected_counts())
        res[impl] = (losses, params,
                     {k: v[0].clone() for k, v in
                      state.stack_opt.mu["layers"]["attn"].items()})
        del state, tr
    (lk, pk, mk), (lr_, pr, mr) = res["kernels"], res["ref"]
    loss_rel = ((lk - lr_).abs() / lr_.abs()).max().item()
    param_diff = max((a - b).abs().max().item() for (_, a), (_, b) in
                     zip(tree_items(pk), tree_items(pr)))
    mom_rel = max(((mk[k] - mr[k]).abs().max() / mr[k].abs().max()).item()
                  for k in mr)
    say(f"[crosscheck] block-parallel fp32 batch (stablelm widths, 4 blocks "
        f"of 1 layer), kernels vs plain versions: losses "
        f"{[round(float(x), 6) for x in lk]} vs "
        f"{[round(float(x), 6) for x in lr_]} (rel max {loss_rel:.2e}) | "
        f"params max|diff| {param_diff:.2e} | block 0 attention first "
        f"moments rel {mom_rel:.2e}; limit 1e-3")
    del res, pk, pr, master
    torch.cuda.empty_cache()
    if not (loss_rel <= 1e-3 and param_diff <= 1e-3 and mom_rel <= 1e-3):
        raise SmokeError("block-parallel fp32 cross-check: kernels and plain "
                         "versions disagree")
    return {"loss_rel": loss_rel, "param_diff": param_diff,
            "moment_rel": mom_rel}


# phase 14b's fault spec (block-parallel, 6 batches of 4 block updates,
# checkpoints every 2 batches, 2 kept): a NaN loss on block 0 in batch 0,
# block 0's pod dead in batch 1 (rewound to generation 1, back in batch 2)
# and the third save (batch 4) torn; the kill after batch 5 then resumes
# past that generation from batch 2's
RUNNER_FAULTS = {"grad_nan": {"at": [1]}, "pod_die": {"at": [2]},
                 "ckpt_corrupt": {"at": [3]}}
RUNNER_COUNTERS = {"pod_deaths": 1, "readoptions": 1, "rewinds": 0,
                   "restarts": 0, "data_stalls": 0, "nan_injected": 1,
                   "degraded_batches": 1, "ckpt_saves": 4}
RUNNER_BATCHES, RUNNER_HALT = 6, 5
# phase 14b's model: stablelm's layer at half its width (16 heads of 64,
# the same d_ff / d_model) and a 32000-token vocabulary. At stablelm's full
# width and vocabulary a generation (masters and both moments) took about
# 7 GB and the phase's saves and loads about 260 s of the script's 1200;
# the runner's checks (counters, the torn generation, the bit-equal resume,
# the restart) do not depend on the width
RUNNER_CUT = dict(d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
                  d_ff=2816, vocab_size=32000)


def _ckpt_lines(tag, mgr) -> list:
    rows = []
    for t in mgr.timings:
        rows.append(t)
        say(f"[runner] {tag} {t['op']} generation {t['generation']}: "
            f"{t['bytes'] / 1e9:.2f} GB in {t['seconds']:.1f} s "
            f"({t['bytes'] / 1e9 / t['seconds']:.2f} GB/s; sha256 "
            f"{t['sha256_s']:.1f} s)")
    return rows


def phase_runner(dev) -> dict:
    """Phase 14b: ``TrainRunner`` on ``runner_model(cut=RUNNER_CUT)`` with 4
    layers, bf16 policy, ``MarkovStream`` through ``HostDataLoader``,
    checkpoints in a temporary directory on the machine's disk (deleted at
    the end). block-parallel (4 blocks of 1): the uninterrupted run under
    ``RUNNER_FAULTS`` (its counters must be ``RUNNER_COUNTERS``), the same
    run killed after batch 5, and its resume, which must fall back past the
    torn generation and end bit-equal to the uninterrupted run (params,
    every moment and step counter, history, heartbeats, guard state). db
    (2 blocks of 2 layers): one ``pod_die`` restart from generation 1, then
    a kill after step 3."""
    import shutil
    import tempfile
    from repro_torch import kernels as K
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import HostDataLoader, MarkovLM, MarkovStream
    from repro_torch.launch.faults import make_injector
    from repro_torch.launch.trainrunner import TrainRunner
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    say(f"[runner] checkpoints under {root} (free "
        f"{shutil.disk_usage(root).free / 1e9:.1f} GB)")
    out = {"launches": {}, "ckpt": []}
    try:
        dbm, master = runner_model(dev, 4, 4, cut=RUNNER_CUT)
        lm = MarkovLM(vocab_size=dbm.cfg.vocab_size, seed=7)

        def make_data(cur):
            src = (lm.stream(TRAIN_BATCH, TRAIN_SEQ) if cur is None
                   else MarkovStream.from_cursor(cur))
            return HostDataLoader(src, device=dev)

        def run(tag, d, faults, mode="block-parallel", model=None, steps=None,
                **kw):
            dbm_, master_ = model or (dbm, master)
            params = _clone(master_)
            tcfg = TrainConfig(
                steps=steps or RUNNER_BATCHES * dbm_.num_blocks,
                warmup_steps=2, lr=1e-4, log_every=0)
            r = TrainRunner(dbm_, tcfg, mode=mode, precision="bf16",
                            ckpt_dir=os.path.join(root, d),
                            ckpt_every=kw.pop("ckpt_every", 2), keep=2,
                            faults=make_injector(faults),
                            pod_restart_after=1, max_restarts=1, log=say)
            gen = torch.Generator(device=dev).manual_seed(1)
            K.reset_launch_counts()
            t0 = time.perf_counter()
            _, hist = r.train(make_data, gen, params=params, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            add_counts(out["launches"], K.launch_counts())
            out["ckpt"] += _ckpt_lines(tag, r.manager)
            say(f"[runner] {tag}: {len(hist)} block updates in {wall:.1f} s "
                f"| counters {r.counters} | heartbeats {r.heartbeats}")
            if not all(math.isfinite(x) or i == 0 for i, (_, _, x)
                       in enumerate(hist)):
                raise SmokeError(f"runner {tag}: a non-finite loss past the "
                                 f"injected one: {hist}")
            return r, params, hist

        a, pa, ha = run("uninterrupted", "a", RUNNER_FAULTS)
        if a.counters != RUNNER_COUNTERS:
            raise SmokeError(f"runner counters {a.counters} != the fault "
                             f"spec's {RUNNER_COUNTERS}")
        shutil.rmtree(os.path.join(root, "a"))
        run("killed", "b", RUNNER_FAULTS, halt_after=RUNNER_HALT)
        c, pc, hc = run("resumed", "b", None, resume=True)
        B = dbm.num_blocks
        checks = {
            "params": _equal(pa, pc),
            "stack moments": _equal(a.state.stack_opt.mu, c.state.stack_opt.mu)
            and _equal(a.state.stack_opt.nu, c.state.stack_opt.nu),
            "step counters": torch.equal(a.state.stack_opt.step,
                                         c.state.stack_opt.step),
            "periphery moments": _equal(a.state.periph_opt.mu,
                                        c.state.periph_opt.mu)
            and _equal(a.state.periph_opt.nu, c.state.periph_opt.nu)
            and int(a.state.periph_opt.step) == int(c.state.periph_opt.step),
            "history": hc == ha[2 * B:],
            "heartbeats": a.heartbeats == c.heartbeats,
            "guard": a.trainer.guard_state() == c.trainer.guard_state(),
            "fell back past the torn generation":
                c.manager.timings[0]["generation"] == 2}
        say(f"[runner] kill after batch {RUNNER_HALT} + resume vs "
            f"uninterrupted, bit-equal: {checks}")
        if not all(checks.values()):
            raise SmokeError(f"runner resume is not bit-identical: {checks}")
        out["resume"] = checks
        del a, c, pa, pc, master
        shutil.rmtree(os.path.join(root, "b"))
        gc.collect()
        torch.cuda.empty_cache()

        # db: generation 1, a restart from it at step 1, then a kill after
        # step 3 of 4 (no final save: one save and one load)
        model = runner_model(dev, 4, 2, cut=RUNNER_CUT)
        r, _, hist = run("db", "db", {"pod_die": {"at": [2]}}, mode="db",
                         model=model, steps=4, ckpt_every=100, halt_after=3)
        if r.counters["restarts"] != 1 or len(hist) != 4:
            raise SmokeError(f"runner db: restarts {r.counters['restarts']},"
                             f" {len(hist)} steps (expected 1 and 4)")
        del r, model
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 14c. the pod-per-block engine: 4 gloo ranks on the one card
# ---------------------------------------------------------------------------
# The ranks (this script run with --mesh-rank), stablelm's depth cut (8 of
# its 24 layers in 4 blocks of 2: masters, moments, grads and the periphery's
# fp32 accumulator come to about 13-15 GB a rank), the batch of a mesh step
# (x TRAIN_SEQ) and the fp32 check's depth (4 blocks of 1 layer). The
# runner's model: stablelm's layer at a quarter of its width with an
# 8192-token vocabulary (at RUNNER_CUT a generation's save and four ranks'
# sha256 checks of it would take 20-30 s of the phase); its faults (block
# 0's pod dead in batch 1, re-adopted in batch 3: two orphan passes), its
# batches and the batch it halts after (no final save: one generation).
# Each rank's collective timeout, and the limit on the group's wall.
MESH_RANKS, MESH_LAYERS, MESH_BATCH, MESH_CHECK_LAYERS = 4, 8, 4, 4
MESH_RUNNER_CUT = dict(d_model=512, n_heads=8, n_kv_heads=8, head_dim=64,
                       d_ff=1408, vocab_size=8192)
MESH_RUNNER_FAULTS = {"pod_die": {"at": [2]}}
MESH_RUNNER_COUNTERS = {"pod_deaths": 1, "readoptions": 1, "rewinds": 0,
                        "restarts": 0, "data_stalls": 0, "nan_injected": 0,
                        "degraded_batches": 2, "ckpt_saves": 1}
MESH_RUNNER_BATCHES, MESH_RUNNER_HALT, MESH_VICTIM = 5, 4, 2
MESH_TIMEOUT_S, MESH_WALL_S = 120, 400


def mesh_tcfg(steps: int = 100):
    from repro_torch.configs.base import TrainConfig
    return TrainConfig(steps=steps, warmup_steps=2, lr=1e-4, log_every=0)


def mesh_batches(dev, dbm):
    """The phase's four engine batches: a warm-up, two timed, and a NaN in
    block ``MESH_VICTIM``'s loss: (tokens, loss_mult) from ``MarkovStream``
    through ``HostDataLoader``."""
    from repro_torch.data import HostDataLoader, MarkovLM
    data = HostDataLoader(MarkovLM(vocab_size=dbm.cfg.vocab_size,
                                   seed=7).stream(MESH_BATCH, TRAIN_SEQ),
                          device=dev)
    nan = [1.0] * dbm.num_blocks
    nan[MESH_VICTIM] = float("nan")
    try:
        return [(next(data), m) for m in (None, None, None, nan)]
    finally:
        data.close()


def mesh_runner(dev, ckpt_dir: str, log):
    """``TrainRunner`` (block-parallel, bf16) at ``MESH_RUNNER_CUT`` under
    ``MESH_RUNNER_FAULTS``; the engine is the mesh under a process group,
    else round robin. Returns (runner, history)."""
    from repro_torch.data import HostDataLoader, MarkovLM, MarkovStream
    from repro_torch.launch.faults import make_injector
    from repro_torch.launch.trainrunner import TrainRunner
    dbm, params = runner_model(dev, 4, 4, cut=MESH_RUNNER_CUT)
    lm = MarkovLM(vocab_size=dbm.cfg.vocab_size, seed=7)

    def make_data(cur):
        src = (lm.stream(MESH_BATCH, TRAIN_SEQ) if cur is None
               else MarkovStream.from_cursor(cur))
        return HostDataLoader(src, device=dev)

    r = TrainRunner(dbm, mesh_tcfg(MESH_RUNNER_BATCHES * dbm.num_blocks),
                    mode="block-parallel", precision="bf16",
                    ckpt_dir=ckpt_dir, ckpt_every=100, keep=2,
                    faults=make_injector(MESH_RUNNER_FAULTS),
                    pod_restart_after=2, log=log)
    gen = torch.Generator(device=dev).manual_seed(1)
    _, hist = r.train(make_data, gen, params=params,
                      halt_after=MESH_RUNNER_HALT)
    return r, hist


def _quiet(*_a, **_k) -> None:
    pass


def mesh_rank(rank: int, out_dir: str) -> int:
    """One rank of phase 14c (``--mesh-rank RANK DIR``): joins the gloo
    group on ``DIR/store``, loads the kernels phase 2 built (rank 0 first),
    runs ``mesh_rank_work`` and writes ``DIR/rank{RANK}.json``."""
    started = time.time()
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.distributed as tdist
    from repro_torch.kernels import _build
    from repro_torch.parallel import dist as D
    dev = torch.device("cuda", 0)
    D.init(dev, "gloo", init_method=f"file://{out_dir}/store", rank=rank,
           world_size=MESH_RANKS, timeout_s=MESH_TIMEOUT_S)
    try:
        if rank == 0:
            for name in _build.SOURCES:
                _build.load(name)
        D.barrier()
        for name in _build.SOURCES:
            _build.load(name)
        out = mesh_rank_work(rank, dev, out_dir)
        out["stamps"]["start"] = started
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        tdist.destroy_process_group()
    return 0


def mesh_rank_work(rank: int, dev, out_dir: str) -> dict:
    """The rank's work: (a) the bf16 engine batches at ``MESH_LAYERS``,
    (b) the runner, (c) one fp32 step at ``MESH_CHECK_LAYERS`` and, on rank
    0, the same step through the round-robin engine. After every batch the
    periphery's bits must agree on every rank."""
    from repro_torch import kernels as K
    from repro_torch.parallel import BlockParallelTrainer
    from repro_torch.parallel import dist as D
    reduce_ms = []
    all_reduce = D.all_reduce

    def timed_all_reduce(t, group=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        all_reduce(t, group)
        reduce_ms.append((time.perf_counter() - t0) * 1e3)
        return t
    D.all_reduce = timed_all_reduce

    def same_periphery(state, what):
        D.check_same(torch.tensor([_bits(state.periph),
                                   _bits(state.periph_opt.mu),
                                   _bits(state.periph_opt.nu)]), what)

    # wall-clock stamps (time.time(), comparable across the processes) of
    # where the rank's time goes: the group joined and the kernels loaded,
    # ready for the go, and the ends of (a), (b) and (c)
    out = {"launches": {}, "stamps": {"joined": time.time()}}
    # (a) the engine at full width, 8 layers in 4 blocks of 2, bf16
    dbm, params = runner_model(dev, MESH_LAYERS, 4)
    tr = BlockParallelTrainer(dbm, mesh_tcfg(), precision="bf16")
    if tr.mode != "shard_map" or tr.blocks != (rank,):
        raise SmokeError(f"rank {rank}: engine {tr.mode}, blocks "
                         f"{tr.blocks}")
    state = tr.init_state(params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(3)
    batches, rows = mesh_batches(dev, dbm), []
    go, t0 = os.path.join(out_dir, "go"), time.perf_counter()
    out["stamps"]["ready"] = time.time()
    while not os.path.exists(go):     # the references are running
        if time.perf_counter() - t0 > MESH_WALL_S:
            raise SmokeError(f"rank {rank}: no go after {MESH_WALL_S} s")
        time.sleep(0.05)
    D.barrier()
    for i, (tokens, mult) in enumerate(batches):
        own = tr.local_trees(state, rank)
        kept = (_bits(own[0]), _bits(own[1].mu), _bits(own[1].nu),
                int(own[1].step))
        reduce_ms.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        state, losses, _ = tr.step(state, tokens, gen, loss_mult=mult)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ms = list(reduce_ms)
        counts = K.launch_counts()
        check_counts(f"mesh rank {rank} batch {i}", counts,
                     db_step_counts(dbm, tr.u))
        add_counts(out["launches"], counts)
        same_periphery(state, f"the periphery after batch {i}")
        own = tr.local_trees(state, rank)
        now = (_bits(own[0]), _bits(own[1].mu), _bits(own[1].nu),
               int(own[1].step))
        rows.append({"losses": losses.tolist(), "wall_ms": wall * 1e3,
                     "reduce_ms": ms,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                     "last_ok": tr.last_ok.tolist(),
                     "unchanged": [a == b for a, b in zip(kept, now)],
                     "step": now[3]})
    out["bf16"] = rows
    out["stamps"]["a"] = time.time()
    del state, tr, batches
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the runner under the mesh: a generation, a pod death, orphan
    # passes on rank 0, a re-adoption
    K.reset_launch_counts()
    t0 = time.perf_counter()
    r, hist = mesh_runner(dev, os.path.join(out_dir, "ckpt"),
                          say if rank == 0 else _quiet)
    torch.cuda.synchronize()
    add_counts(out["launches"], K.launch_counts())
    same_periphery(r.state, "the periphery after the runner")
    out["runner"] = {"history": hist, "counters": r.counters,
                     "heartbeats": r.heartbeats, "engine": r.trainer.mode,
                     "launches": K.launch_counts(),
                     "wall_s": time.perf_counter() - t0}
    out["stamps"]["b"] = time.time()
    del r
    gc.collect()
    torch.cuda.empty_cache()

    # (c) fp32 at 4 layers (4 blocks of 1) through the kernels; rank 0 then
    # runs the same step through the round-robin engine
    dbm, params = runner_model(dev, MESH_CHECK_LAYERS, 4)
    tokens = torch.randint(0, dbm.cfg.vocab_size, (MESH_BATCH, TRAIN_SEQ),
                           generator=torch.Generator(device=dev)
                           .manual_seed(5), device=dev)
    tr = BlockParallelTrainer(dbm, mesh_tcfg(), precision="fp32")
    state = tr.init_state(params)
    del params
    state, losses, _ = tr.step(state, tokens,
                               torch.Generator(device=dev).manual_seed(6))
    same_periphery(state, "the periphery after the fp32 step")
    full = tr.full_params(state)
    del state, tr
    gc.collect()
    torch.cuda.empty_cache()
    if rank == 0:
        from repro_torch.nn.init import tree_items
        rdbm, rparams = runner_model(dev, MESH_CHECK_LAYERS, 4)
        rr = BlockParallelTrainer(rdbm, mesh_tcfg(), precision="fp32",
                                  devices=[dev])
        rs, rl, _ = rr.step(rr.init_state(rparams), tokens,
                            torch.Generator(device=dev).manual_seed(6))
        want = dict(tree_items(rr.full_params(rs)))
        out["fp32"] = {
            "losses": losses.tolist(), "ref_losses": rl.tolist(),
            "loss_rel": ((losses - rl).abs() / rl.abs()).max().item(),
            "param_rel": max(((x - want[p]).abs().max()
                              / want[p].abs().max()).item()
                             for p, x in tree_items(full))}
        del rs, rr, rparams, want
    del full
    gc.collect()
    torch.cuda.empty_cache()
    D.barrier()
    out["stamps"]["c"] = time.time()
    return out


def phase_mesh(dev) -> dict:
    """Phase 14c: the pod-per-block engine (``BlockParallelTrainer`` in its
    ``shard_map`` mode) on ``MESH_RANKS`` ranks of this script, each on the
    one card, under gloo (NCCL refuses two ranks on one device). First the
    round-robin engine in this process: the same four batches of the same
    model (seeded alike) and the runner, for the losses to hold the mesh
    to. Then the ranks: (a) stablelm-1.6b at full width, 8 layers in 4
    blocks of 2, bf16: a warm-up, two timed batches (wall, each rank's
    all-reduce ms and peak), a NaN on block ``MESH_VICTIM`` (its stack,
    moments and counter bit-unchanged, the others moved); (b) the runner
    (one generation, a pod death, orphan passes on rank 0, a
    re-adoption; counters ``MESH_RUNNER_COUNTERS``); (c) fp32 at 4 layers
    against the round-robin engine on rank 0 (losses and every param within
    1e-5 relative). The periphery bit-equal on every rank after every
    batch; each batch's losses within 1e-3 relative of the round robin's;
    each rank's launches each block update's DB-step arithmetic."""
    import shutil
    import tempfile
    from repro_torch.parallel import BlockParallelTrainer
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    logs = [open(os.path.join(root, f"rank{r}.log"), "w")
            for r in range(MESH_RANKS)]
    # the ranks start up (a process, a CUDA context, their blocks) while
    # this process runs the round-robin references; they take no batch
    # before the "go" file exists
    spawned = time.time()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--mesh-rank",
         str(r), root], stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(MESH_RANKS)]
    try:
        dbm, params = runner_model(dev, MESH_LAYERS, 4)
        tr = BlockParallelTrainer(dbm, mesh_tcfg(), precision="bf16")
        state = tr.init_state(params)
        gen = torch.Generator(device=dev).manual_seed(3)
        ref, ref_ms = [], []
        for tokens, mult in mesh_batches(dev, dbm):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, losses, _ = tr.step(state, tokens, gen, loss_mult=mult)
            torch.cuda.synchronize()
            ref_ms.append((time.perf_counter() - t1) * 1e3)
            ref.append(losses.tolist())
        del state, tr, params
        gc.collect()
        torch.cuda.empty_cache()
        rr, rr_hist = mesh_runner(dev, os.path.join(root, "rr"), _quiet)
        rr_counters = dict(rr.counters)
        del rr
        gc.collect()
        torch.cuda.empty_cache()
        say(f"[mesh] round-robin references ({MESH_LAYERS} layers in 4 "
            f"blocks, bf16, {MESH_BATCH}x{TRAIN_SEQ}; the runner at "
            f"MESH_RUNNER_CUT) in {time.perf_counter() - t0:.1f} s; batch "
            f"walls {[round(x, 1) for x in ref_ms]} ms")
        Path(root, "go").touch()
        t1, went = time.perf_counter(), time.time()
        for p in procs:
            p.wait(timeout=max(1.0, MESH_WALL_S - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
        if not Path(root, "go").exists():     # the references failed
            shutil.rmtree(root, ignore_errors=True)
    try:
        wall = time.perf_counter() - t1
        with open(os.path.join(root, "rank0.log")) as f:
            for line in f.read().splitlines():
                say(f"[mesh r0] {line}")
        failed = [r for r, p in enumerate(procs) if p.returncode != 0]
        if failed:
            with open(os.path.join(root, f"rank{failed[0]}.log")) as f:
                tail = f.read()[-3000:]
            raise SmokeError(f"mesh ranks {failed} failed (exit codes "
                             f"{[procs[r].returncode for r in failed]}; "
                             f"rank {failed[0]}'s log ends):\n{tail}")
        res = []
        for r in range(MESH_RANKS):
            with open(os.path.join(root, f"rank{r}.json")) as f:
                res.append(json.load(f))
    finally:
        shutil.rmtree(root, ignore_errors=True)

    def rel(got, want):
        return max((0.0 if (math.isnan(g) and math.isnan(w))
                    else abs(g - w) / abs(w)) for g, w in zip(got, want))

    out = {"launches": {}, "wall_s": wall}
    say(f"[mesh] the ranks' batches to their end: {wall:.1f} s after the "
        f"go (the phase {time.perf_counter() - t0:.1f} s)")
    for r, rr_ in enumerate(res):
        add_counts(out["launches"], rr_["launches"])
    st = [x["stamps"] for x in res]
    say(f"[mesh] where the phase's time goes (s from the spawn, ranks "
        f"0-3): interpreter and imports up to "
        f"{max(x['start'] for x in st) - spawned:.1f}, group joined and "
        f"kernels loaded {max(x['joined'] for x in st) - spawned:.1f}, "
        f"ready (model built) {max(x['ready'] for x in st) - spawned:.1f}; "
        f"the references done and the go at {went - spawned:.1f}; (a) the "
        f"bf16 batches end at {max(x['a'] for x in st) - spawned:.1f}, (b) "
        f"the runner at {max(x['b'] for x in st) - spawned:.1f}, (c) the "
        f"fp32 check at {max(x['c'] for x in st) - spawned:.1f}")
    rows = res[0]["bf16"]
    worst = max(rel(row["losses"], want) for row, want in zip(rows, ref))
    for i, row in enumerate(rows):
        say(f"[mesh] batch {i}: losses {[round(x, 4) for x in row['losses']]}"
            f" (round robin {[round(x, 4) for x in ref[i]]}) | wall "
            f"{row['wall_ms']:.1f} ms (round robin {ref_ms[i]:.1f}) | "
            f"all-reduce ms by rank "
            f"{[round(sum(x['bf16'][i]['reduce_ms']), 1) for x in res]} | "
            f"peak GiB by rank "
            f"{[round(x['bf16'][i]['peak_gib'], 2) for x in res]}")
    nan = [x["bf16"][3] for x in res]
    victim_ok = all(n["unchanged"] == [r == MESH_VICTIM] * 4
                    and n["last_ok"] == [b != MESH_VICTIM for b in range(4)]
                    and n["step"] == 3 + (r != MESH_VICTIM)
                    for r, n in enumerate(nan))
    say(f"[mesh] NaN on block {MESH_VICTIM}: each rank's block bit-unchanged"
        f" (stack, mu, nu, step): {[n['unchanged'] for n in nan]}; step "
        f"counters {[n['step'] for n in nan]}")
    run = [x["runner"] for x in res]
    hist_rel = rel([h[2] for h in run[0]["history"]],
                   [h[2] for h in rr_hist])
    runner_ok = (all(x["counters"] == MESH_RUNNER_COUNTERS == rr_counters
                     and x["engine"] == "shard_map"
                     and x["heartbeats"] == run[0]["heartbeats"]
                     for x in run)
                 and [h[:2] for h in run[0]["history"]]
                 == [list(h[:2]) for h in rr_hist])
    say(f"[mesh] runner: {len(run[0]['history'])} block updates in "
        f"{run[0]['wall_s']:.1f} s | counters {run[0]['counters']} "
        f"(round robin {rr_counters}) | heartbeats {run[0]['heartbeats']} "
        f"| losses vs round robin rel max {hist_rel:.2e} | launches by rank "
        f"{[sum(x['launches'].values()) for x in run]}")
    fp = res[0]["fp32"]
    say(f"[mesh] fp32, {MESH_CHECK_LAYERS} blocks of 1 layer, mesh vs round "
        f"robin: losses {[round(x, 6) for x in fp['losses']]} vs "
        f"{[round(x, 6) for x in fp['ref_losses']]} (rel max "
        f"{fp['loss_rel']:.2e}) | params rel max {fp['param_rel']:.2e}; "
        f"limit 1e-5")
    say(f"[mesh] bf16 losses vs round robin rel max {worst:.2e} (limit "
        f"1e-3)")
    # every block update of the runner's 4 batches (rank 0's orphan passes
    # included) is one layer's concat DB step
    expect = expected_counts(**{n: 4 * MESH_RUNNER_HALT for n in ATTN})
    runner_counts = {}
    for x in run:
        add_counts(runner_counts, x["launches"])
    check_counts("mesh runner (all ranks)", runner_counts, expect)
    if not (worst <= 1e-3 and victim_ok and runner_ok and hist_rel <= 1e-3
            and fp["loss_rel"] <= 1e-5 and fp["param_rel"] <= 1e-5):
        raise SmokeError("mesh: the pod-per-block engine disagrees with the "
                         "round-robin engine or its guard")
    out.update(rows=rows, ref_ms=ref_ms, runner=run[0], fp32=fp,
               loss_rel=worst)
    return out


# kernels no main path launches: the samplers run under no_grad, so the
# Euler backward is held against its plain version in phase 3 only
# ---------------------------------------------------------------------------
# 15. the VLM: llama-3.2-vision-11b at full width, conditioned serving
# ---------------------------------------------------------------------------

def vlm_model(dev, n_layers=None, blocks=None, cross_every=None,
              spec_only=False):
    """llama-3.2-vision-11b (cut to ``n_layers`` in whole superblocks where
    given, of ``cross_every`` layers where given) in DEFAULT_DB's blocks (or
    ``blocks``), random fp32 weights from seed 0, the AdaLN heads
    randomised and the cross gates opened (``xgate`` is zero at init, and
    tanh(0) = 0 would make every cross layer add nothing). Returns (dbm,
    params, gen), or the dbm alone with ``spec_only`` (nothing
    allocated)."""
    from repro_torch.configs import DEFAULT_DB, get_config
    from repro_torch.core.blocks import DiffusionBlocksModel
    cfg = get_config(VLM_ARCH)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    if cross_every is not None:
        cfg = dataclasses.replace(cfg, cross_attn_every=cross_every)
    db = (DEFAULT_DB if blocks is None
          else dataclasses.replace(DEFAULT_DB, num_blocks=blocks))
    dbm = DiffusionBlocksModel(cfg, db)
    if spec_only:
        return dbm
    gen = torch.Generator(device=dev).manual_seed(0)
    params = dbm.init(gen)
    for part in ("self", "cross"):
        for k in ("w", "b"):
            params["units"][part]["adaln"][k].normal_(0.0, 0.02,
                                                      generator=gen)
    params["units"]["cross"]["xgate"].fill_(VLM_XGATE)
    return dbm, params, gen


def vlm_queue(vocab: int, n_images: int):
    """Phase 15's continuous traffic: CB_REQUESTS ``MarkovLM`` prompts from
    seed 1 (CB_MIN-CB_MAX tokens), the ones in VLM_COND (30%, JAX's
    ``cond_frac``) each with an image, round robin over the registry;
    then VLM_TWINS, submitted once their originals' prompts are in the
    prefix cache: request 0's text under another image, request 3's text
    and image, request 0's text with none. Returns ([(prompt, image index
    or None)] of the first CB_REQUESTS - 3, the three twins)."""
    import numpy as np
    from repro_torch.data import MarkovLM
    lm = MarkovLM(vocab_size=vocab, seed=7)
    rs = np.random.RandomState(1)
    n = CB_REQUESTS - len(VLM_TWINS)
    prompts = [lm.sample(rs, 1, rs.randint(CB_MIN, CB_MAX + 1))[0]
               for _ in range(n)]
    cond = {i: j % n_images for j, i in enumerate(VLM_COND)}
    first = [(p, cond.get(i)) for i, p in enumerate(prompts)]
    twins = [(prompts[0], (cond[0] + 1) % n_images), (prompts[3], cond[3]),
             (prompts[0], None)]
    return first, twins


def vlm_bounds(dbm, params, plens, images: int) -> dict:
    """Least device time of the static run from its shapes (as
    ``serve_bounds``): a decode step's 4 probes read every unit weight in
    fp32 plus the fp32 head and σ-MLP, the commit reads the bf16
    attention+MLP copy; each pass over the 32 self layers reads the
    slots' committed K/V and each of the 2 passes (probes, commit) every
    slot's image block (bf16); a prefill chunk reads the bf16 copy, every
    padded token's K/V row and the image blocks once."""
    cfg, B = dbm.cfg, BATCH
    A, _ = paged_layers(dbm)
    m = dbm.model
    unit_all = sum(t.numel() for _, t in _leaves(params["units"]))
    commit = sum(t.numel() for p, t in _leaves(params["units"])
                 if p[1] in ("attn", "mlp"))
    head = params["head"]["w"].numel()
    cond = sum(t.numel() for _, t in _leaves(params["cond"]))
    kv_row = 2 * cfg.n_kv_heads * cfg.head_dim * 2
    cross = m.n_units * images * cfg.n_image_tokens * kv_row
    x_flops = (2 * m.n_units * images * cfg.n_image_tokens * cfg.n_heads
               * cfg.head_dim * 4)
    n_chunks = -(-PROMPT // CHUNK)
    pre = bound(n_chunks * (commit * 2 + cross) + A * B * PROMPT * kv_row,
                2 * commit * B * n_chunks * CHUNK
                + n_chunks * CHUNK * x_flops / 2, PEAK_BF16)
    mean_len = float(sum(plens)) / B + (MAX_NEW - 1) / 2
    attn_flops = 2 * A * B * mean_len * cfg.n_heads * cfg.head_dim * 4
    dec = bound(unit_all * 4 + dbm.num_blocks * cond * 4 + head * 4
                + commit * 2 + 2 * A * B * mean_len * kv_row + 2 * cross,
                2 * B * (unit_all + head + commit) + attn_flops + x_flops,
                PEAK_FP32)
    return {"prefill_ms": pre[0], "prefill_by": pre[1],
            "decode_step_ms": dec[0], "decode_step_by": dec[1]}


def vlm_cross_attend(dev, dbm) -> dict:
    """``cross_attend`` (plain torch, as JAX's is plain jnp) at the
    probe's and the commit's shapes: 8 slots, one query a slot, over full
    1601-token bf16 image blocks; device ms per call by CUDA-graph replay
    (16 calls, one decode step's: 8 units, probes and commit), its bound
    (each block read once), and one step's calls under the profiler."""
    from repro_torch.nn.cache import cross_attend
    cfg = dbm.cfg
    gen = torch.Generator(device=dev).manual_seed(3)
    k, v = (torch.randn((BATCH, cfg.n_image_tokens, cfg.n_kv_heads,
                         cfg.head_dim), generator=gen, device=dev
                        ).to(torch.bfloat16) for _ in range(2))
    lens = torch.full((BATCH,), cfg.n_image_tokens, dtype=torch.int32,
                      device=dev)
    out = {}
    for name, dt in (("probe", torch.float32), ("commit", torch.bfloat16)):
        q = torch.randn((BATCH, 1, cfg.n_heads, cfg.head_dim),
                        generator=gen, device=dev).to(dt)
        ms = device_ms(lambda i: cross_attend(q, k.to(dt), v.to(dt), lens),
                       1)
        out[name] = ms
    nbytes = 2 * k.numel() * k.element_size()
    b_ms, by = bound(nbytes, 4 * BATCH * cfg.n_heads * cfg.n_image_tokens
                     * cfg.head_dim, PEAK_FP32)
    q = torch.randn((BATCH, 1, cfg.n_heads, cfg.head_dim), generator=gen,
                    device=dev)
    pwall, busy, top = device_busy(lambda: [
        cross_attend(q, k.float(), v.float(), lens)
        for _ in range(2 * dbm.model.n_units)], top=6)
    units = dbm.model.n_units
    say(f"[vlm] cross_attend (plain torch) at {BATCH} slots x "
        f"{cfg.n_image_tokens} bf16 image tokens, KV={cfg.n_kv_heads} "
        f"G={cfg.n_heads // cfg.n_kv_heads} hd {cfg.head_dim}: probe (fp32 "
        f"q, the block upcast as "
        f"the layer casts it) {out['probe']:.4f} ms, commit (bf16 q) "
        f"{out['commit']:.4f} ms a call (CUDA-graph replay) against a "
        f"bound of {b_ms:.4f} ms ({by}; the block read once); "
        f"{2 * units} calls a decode step: "
        f"{units * (out['probe'] + out['commit']):.3f} ms")
    say(f"[vlm] one step's {2 * units} probe calls under the profiler: "
        f"device busy {busy:.2f} ms of {pwall:.1f} ms")
    for ms, count, key in top:
        say(f"[vlm]   {ms:8.3f} ms  x{count:<5d} {key[:90]}")
    out.update(bound_ms=b_ms, step_ms=units * (out["probe"] + out["commit"]),
               profiled_busy_ms=busy)
    return out


def vlm_static(dev, model, pool) -> dict:
    """The static engine over 8 requests, each with its image (prompts
    padded to 512, ragged 128-512, chunk 64, 32 new tokens), and the same
    prompts and draws without images: the tokens must differ."""
    import numpy as np
    from repro_torch import kernels as K
    from repro_torch.launch.serve import get_engine
    dbm, params, gen = model
    cfg = dbm.cfg
    A, G = paged_layers(dbm)
    prompts, plens = prompts_np(cfg.vocab_size)
    key, images = pool
    aux = {key: np.stack([images[i % len(images)] for i in range(BATCH)])}
    eng = get_engine(dbm, precision="bf16", chunk_size=CHUNK)
    # warm-up at the same shapes, 2 tokens (cuBLAS heuristics, allocator)
    eng.generate(params, prompts, 2, prompt_lengths=plens, generator=gen,
                 aux_inputs=aux)
    eng.last_kv = None
    z, _ = eng.draw(MAX_NEW, BATCH, gen, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.generate(params, prompts, MAX_NEW, prompt_lengths=plens,
                       z0=z, aux_inputs=aux)
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    tim = eng.last_timing
    expect = expected_counts(flash_decode=MAX_NEW * 2 * A,
                             gate_residual=MAX_NEW * G,
                             flash_prefill=-(-PROMPT // CHUNK) * A)
    check_counts("vlm static", counts, expect)
    kv = eng.last_kv
    for name, t in (("self k", kv["self"].k), ("self v", kv["self"].v),
                    ("cross k", kv["cross"]["k"]),
                    ("cross v", kv["cross"]["v"])):
        if not torch.isfinite(t.float()).all():
            raise SmokeError(f"vlm static: non-finite {name} after serving")
    eng.last_kv = kv = None
    K.reset_launch_counts()
    bare = eng.generate(params, prompts, MAX_NEW, prompt_lengths=plens,
                        z0=z)
    check_counts("vlm static, no images", K.launch_counts(), expect)
    add_counts(counts, K.launch_counts())
    eng.last_kv = None
    got, ref = _generated(out, plens), _generated(bare, plens)
    if not ((got >= 0) & (got < cfg.vocab_size)).all():
        raise SmokeError("vlm static: generated token outside the vocabulary")
    differ = (got != ref).any(dim=1)
    decode_ms = tim["total_ms"] - tim["prefill_ms"]
    lb = vlm_bounds(dbm, params, plens, BATCH)
    say(f"[vlm] static: bf16, greedy, {BATCH} requests each with an image "
        f"({len(images)} in the registry), prompts padded to {PROMPT} "
        f"(lengths {plens.tolist()}), chunk {CHUNK}, {MAX_NEW} new tokens")
    say(f"[vlm] static: wall {wall:.3f} s | {BATCH * MAX_NEW / wall:.1f} "
        f"tok/s | ttft {tim['ttft_ms']:.1f} ms (conditioning write and "
        f"prefill {tim['prefill_ms']:.1f} ms) | decode "
        f"{decode_ms / MAX_NEW:.2f} ms/step | peak memory "
        f"{peak / 2**30:.2f} GiB | bound from the shapes: prefill "
        f"{lb['prefill_ms']:.2f} ms ({lb['prefill_by']}), decode "
        f"{lb['decode_step_ms']:.2f} ms/step ({lb['decode_step_by']})")
    say(f"[vlm] static: launches {counts} (each run: 2 x {A} paged decodes "
        f"and {G} gate-residuals a step, {A} prefills a chunk)")
    say(f"[vlm] static: the same prompts and draws without images: tokens "
        f"differ in {int(differ.sum())} of {BATCH} requests")
    if not differ.any():
        raise SmokeError("vlm static: conditioning did not change a token")
    return {"counts": counts, "wall_s": wall, "ttft_ms": tim["ttft_ms"],
            "prefill_ms": tim["prefill_ms"],
            "decode_ms_per_step": decode_ms / MAX_NEW, "peak": peak,
            "bounds": lb}


def vlm_batcher_run(dev, model, pool, first, twins, *, graphs=True,
                    n_seg=None):
    """A fresh 8-slot batcher (graphs captured first) over ``first``, the
    twins submitted as interactive requests once requests 0 and 3 have
    their prompts in the prefix cache; to the end, or until ``n_seg``
    segments ran. Returns (batcher, requests, capture s, events)."""
    dbm, params, _ = model
    key, images = pool
    cb = cb_batcher(dev, model, graphs=graphs)
    t0 = time.perf_counter()
    cb.capture()
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    events = cb_timed(cb)

    def aux(i):
        return None if i is None else {key: images[i]}
    for p, i in first:
        cb.submit(p, CB_NEW, aux_inputs=aux(i))
    reqs = list(cb.queue)
    pending = list(twins)
    while cb.has_work() or pending:
        if pending and reqs[0].registered and reqs[3].registered:
            for p, i in pending:
                cb.submit(p, CB_NEW, aux_inputs=aux(i),
                          priority="interactive")
            reqs += list(cb.queue)[-len(pending):]
            pending = []
        cb.step()
        if n_seg is not None and cb.decode_dispatches >= n_seg:
            break
    torch.cuda.synchronize()
    return cb, reqs, capture_s, events


def vlm_continuous(dev, model, pool) -> dict:
    """The continuous batcher: the timed run over ``vlm_queue``, then the
    graph against eager over the first CB_CHECK_SEGMENTS segments."""
    from repro_torch import kernels as K
    dbm = model[0]
    first, twins = vlm_queue(dbm.cfg.vocab_size, len(pool[1]))
    K.reset_launch_counts()
    t0 = time.perf_counter()
    cb, reqs, capture_s, events = vlm_batcher_run(dev, model, pool, first,
                                                  twins)
    wall = time.perf_counter() - t0 - capture_s
    counts = K.launch_counts()
    ledger = [srv_ledger(cb)]
    check_counts("vlm continuous", counts, srv_counts(ledger))
    cb_drained("vlm continuous", cb, reqs, CB_REQUESTS)
    if cb.cond_lengths.any():
        raise SmokeError(f"vlm continuous: image rows left set "
                         f"{cb.cond_lengths.tolist()}")
    other, same, bare = reqs[-3:]
    say(f"[vlm] continuous: the prefix cache keeps images apart: request "
        f"0's text under another image shared {other.shared_tokens} "
        f"tokens, request 3's text and image {same.shared_tokens} (of "
        f"{len(same.prompt)}), request 0's text without an image "
        f"{bare.shared_tokens}")
    if other.shared_tokens or bare.shared_tokens or not same.shared_tokens:
        raise SmokeError("vlm continuous: prefix pages shared across images, "
                         "or none for the same text and image")
    seg_ms = [s.elapsed_time(e) for s, e in events["segment"]]
    chunk_ms = [s.elapsed_time(e) for s, e in events["chunk"]]
    in_dispatch = (sum(seg_ms) + sum(chunk_ms)) / (wall * 1e3)
    ttft = sorted(r.ttft for r in reqs)
    n_tok = sum(len(r.out) for r in reqs)
    n_cond = sum(r.aux_inputs is not None for r in reqs)
    pool_mb = {k: round(v / 1e6, 1)
               for k, v in cb.kv_stats()["kv_bytes_by_dtype"].items()}
    say(f"[vlm] continuous: {CB_REQUESTS} requests ({n_cond} with an "
        f"image) on {CB_SLOTS} slots, bf16, greedy, page {PSZ}, chunk "
        f"{CHUNK}, seg_len {CB_SEG}, prefix cache on, {CB_NEW} new tokens "
        f"each; segments replayed from the graph captured in "
        f"{capture_s:.2f} s (warm-ups {cb.graph_warmups})")
    say(f"[vlm] continuous: wall {wall:.3f} s | {n_tok / wall:.1f} tok/s | "
        f"TTFT median {statistics.median(ttft) * 1e3:.1f} ms, max "
        f"{ttft[-1] * 1e3:.1f} ms | decode {sum(seg_ms) / cb.steps:.3f} ms "
        f"per segment step ({len(seg_ms)} segments) | chunk dispatch "
        f"{statistics.median(chunk_ms):.2f} ms median ({len(chunk_ms)}) | "
        f"inside a dispatch {100 * in_dispatch:.1f}% of the wall (CUDA "
        f"events) | prefix hits {cb.prefix.hits}, CoW copies "
        f"{cb.cow_copies} | pool and image blocks MB {pool_mb}")
    del cb, reqs, events
    torch.cuda.empty_cache()

    K.reset_launch_counts()
    runs = [vlm_batcher_run(dev, model, pool, first, [], graphs=g,
                            n_seg=CB_CHECK_SEGMENTS) for g in (True, False)]
    outs = [[list(r.out) for r in reqs] for _, reqs, _, _ in runs]
    add_counts(counts, K.launch_counts())
    ledger += [srv_ledger(c) for c, _, _, _ in runs]
    # pages 1 and up (idle slots write the trash page 0) and the blocks
    pools = [[t.narrow(2, 1, t.shape[2] - 1) for t in
              (c.kv["self"].k, c.kv["self"].v)] + [c.kv["cross"]["k"],
                                                  c.kv["cross"]["v"]]
             for c, _, _, _ in runs]
    equal = all(torch.equal(a, b) for a, b in zip(*pools))
    say(f"[vlm] continuous: graph vs eager, first {CB_CHECK_SEGMENTS} "
        f"segments: tokens {'identical' if outs[0] == outs[1] else 'DIFFER'}"
        f" ({sum(map(len, outs[0]))} tokens), pools and image blocks "
        f"{'bit-equal' if equal else 'DIFFER'}")
    if outs[0] != outs[1] or not equal or not sum(map(len, outs[0])):
        raise SmokeError("vlm continuous: the graph's segments differ from "
                         "the eager ones")
    del runs
    torch.cuda.empty_cache()
    check_counts("vlm continuous, all runs", counts, srv_counts(ledger))
    return {"counts": counts, "wall_s": wall, "tok_s": n_tok / wall,
            "ttft_median_s": statistics.median(ttft),
            "segment_step_ms": sum(seg_ms) / max(1, len(seg_ms)) / CB_SEG,
            "chunk_ms_median": statistics.median(chunk_ms),
            "in_dispatch": in_dispatch, "capture_s": capture_s}


def vlm_migration(dev, model, pool) -> dict:
    """VLM_MIGRATE conditioned requests one at a time through a
    one-slot ``pages`` router (1 prefill + 1 decode worker on one shared
    pool) and through a one-slot graphed batcher under the same generator
    seed: each request's tokens equal, bit for bit."""
    from repro_torch import kernels as K
    key, images = pool
    first, _ = vlm_queue(model[0].cfg.vocab_size, len(images))
    reqs = [(p, VLM_MIGRATE_NEW, {key: images[j % len(images)]})
            for j, (p, _) in enumerate(first[:VLM_MIGRATE])]
    K.reset_launch_counts()
    cb = cb_batcher(dev, model, seed=5, num_slots=1)
    cb.capture()
    direct = []
    for p, n, aux in reqs:
        cb.submit(p, n, aux_inputs=aux)
        direct.append(cb.run()[0].out)
    ledger = [srv_ledger(cb)]
    del cb
    router = dg_router(model, "pages", num_slots=1, n_decode=1)
    router.decode_workers[0].cb.generator.manual_seed(5)
    routed = dg_sequential(router, reqs)
    whole = dg_whole("vlm migration", router)
    ledger += [srv_ledger(w.cb) for w in router.workers]
    migrations = router.migrations
    del router
    counts = K.launch_counts()
    check_counts("vlm migration", counts, srv_counts(ledger))
    say(f"[vlm] migration: {VLM_MIGRATE} conditioned requests one at a "
        f"time through a pages router (1 prefill + 1 decode worker, one "
        f"slot each, one shared pool) "
        f"{'equal' if routed == direct else 'DIFFER FROM'} a graphed "
        f"batcher's under the same draws, bit for bit "
        f"({sum(map(len, direct))} tokens, {migrations} migrations) | pool "
        f"{whole}")
    if routed != direct or migrations < VLM_MIGRATE:
        raise SmokeError(f"vlm migration: routed {routed}, direct {direct}")
    return {"counts": counts}


def vlm_fp32_check(dev, pool) -> dict:
    """2 superblocks (10 layers) at full width in 2 blocks, fp32: 8 requests
    (5 with an image) for one segment through the kernels and through
    ``impl="ref"``; the logits within 1e-3 relative and the greedy tokens
    equal."""
    import numpy as np
    from repro_torch import kernels as K
    model = vlm_model(dev, n_layers=2 * VLM_CUT_EVERY, blocks=2)
    key, images = pool
    first, _ = vlm_queue(model[0].cfg.vocab_size, len(images))
    few = [p for p, _ in first[:CB_SLOTS]]
    auxes = [None if j % 3 == 1 else {key: images[j % len(images)]}
             for j in range(CB_SLOTS)]
    K.reset_launch_counts()
    ck, lk, ek = cb_logged(dev, model, few, "fp32", "kernels", n_seg=1,
                           auxes=auxes)
    counts = K.launch_counts()
    check_counts("vlm fp32", counts, cb_counts(model[0], ck))
    _, lr, er = cb_logged(dev, model, few, "fp32", "ref", n_seg=1,
                          auxes=auxes)
    on = ek[0] >= 0
    rel = max(((lk[t] - lr[t])[on[:, t]].abs().max()
               / lr[t][on[:, t]].abs().max()).item()
              for t in range(CB_SEG) if on[:, t].any())
    equal = bool(np.array_equal(ek, er))
    say(f"[vlm] fp32 depth cut ({2 * VLM_CUT_EVERY} layers, 2 blocks, full "
        f"width), {CB_SLOTS} requests ({sum(a is not None for a in auxes)} "
        f"with an image), one segment, kernels vs plain versions: logits "
        f"rel max|diff| {rel:.2e} (limit 1e-3) | greedy tokens "
        f"{'equal' if equal else 'DIFFER'} ({int(on.sum())})")
    if not (rel <= 1e-3 and math.isfinite(rel)) or not equal:
        raise SmokeError(f"vlm fp32 cross-check: logits {rel:.2e}, tokens "
                         f"equal {equal}")
    return {"counts": counts, "logits_rel": rel}


def phase_vlm(dev) -> dict:
    """Phase 15: llama-3.2-vision-11b at full width (see the module
    docstring). The fp32 masters and their bf16 copy take about 68 GiB,
    so nothing else may be resident."""
    from repro_torch.launch.serve import conditioning_pool
    import numpy as np
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    clear_cublas_workspaces()
    base = torch.cuda.memory_allocated()
    say(f"[vlm] memory allocated at the phase's start: "
        f"{base / 2**30:.3f} GiB")
    if base > VLM_MEM_START:
        raise SmokeError(f"vlm: {base / 2**30:.2f} GiB still allocated from "
                         "earlier phases")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = vlm_model(dev)
    dbm, params, _ = model
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in _leaves(params))
    cfg = dbm.cfg
    pool = conditioning_pool(dbm, VLM_POOL, np.random.RandomState(1))
    say(f"[vlm] {cfg.name}: {cfg.n_layers} layers ({dbm.model.n_units} "
        f"superblocks of {dbm.model.k_self} self + 1 cross) d={cfg.d_model} "
        f"heads={cfg.n_heads} kv={cfg.n_kv_heads} hd={cfg.head_dim} "
        f"ff={cfg.d_ff} vocab={cfg.vocab_size}, {cfg.n_image_tokens} image "
        f"tokens, {dbm.num_blocks} blocks {dbm.ranges}; {n_params / 1e9:.3f}"
        f" B params fp32 made in {time.perf_counter() - t0:.1f} s; cross "
        f"gates tanh({VLM_XGATE}); {VLM_POOL} images ({cfg.n_image_tokens}"
        f", {cfg.d_model}) fp32 from seed 1")
    counts = {}
    xa = vlm_cross_attend(dev, dbm)
    static = vlm_static(dev, model, pool)
    add_counts(counts, static["counts"])
    cont = vlm_continuous(dev, model, pool)
    add_counts(counts, cont["counts"])
    mig = vlm_migration(dev, model, pool)
    add_counts(counts, mig["counts"])
    peak = torch.cuda.max_memory_allocated()
    say(f"[vlm] peak memory at full width {peak / 2**30:.2f} GiB (reckoned: "
        f"55.3 GB fp32 masters + 17.4 GB bf16 copy = 67.7 GiB, plus pools, "
        f"image blocks and transients) of "
        f"{torch.cuda.get_device_properties(dev).total_memory / 2**30:.1f}")
    del model, dbm, params
    torch.cuda.empty_cache()
    fp32 = vlm_fp32_check(dev, pool)
    add_counts(counts, fp32["counts"])
    torch.cuda.empty_cache()
    clear_cublas_workspaces()
    left = torch.cuda.memory_allocated()
    say(f"[vlm] with everything dropped (no gc pass): {left / 2**30:.3f} GiB"
        f" allocated against {base / 2**30:.3f} GiB at the start")
    if left - base > VLM_MEM_SLACK:
        raise SmokeError(f"vlm: {(left - base) / 2**30:.2f} GiB left "
                         "allocated after the phase")
    took = time.perf_counter() - t_phase
    say(f"[vlm] phase 15 took {took:.1f} s | launches {counts}")
    return {"counts": counts, "static": static, "continuous": cont,
            "cross_attend": xa, "peak": peak, "fp32_rel": fp32["logits_rel"],
            "seconds": took}


# ---------------------------------------------------------------------------
# 16. the hybrid: zamba2-7b at full width
# ---------------------------------------------------------------------------

def hyb_model(dev, n_units=None, blocks=None):
    """zamba2-7b (cut to ``n_units`` units of 3 Mamba layers and the shared
    block where given) in DEFAULT_DB's blocks (or ``blocks``), random fp32
    weights from seed 0, the AdaLN heads randomised (zero at init: identity
    modulation, gates of 1). Returns (dbm, params, gen)."""
    from repro_torch.configs import DEFAULT_DB, get_config
    from repro_torch.core.blocks import DiffusionBlocksModel
    cfg = get_config(HYB_ARCH)
    if n_units is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_units * cfg.attn_every)
    db = (DEFAULT_DB if blocks is None
          else dataclasses.replace(DEFAULT_DB, num_blocks=blocks))
    dbm = DiffusionBlocksModel(cfg, db)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = dbm.init(gen)
    for part in (params["units"]["mamba"], params["shared"]):
        for k in ("w", "b"):
            part["adaln"][k].normal_(0.0, 0.02, generator=gen)
    return dbm, params, gen


def hyb_prompts(vocab: int, n: int, lo: int, hi: int, seed: int) -> list:
    """``n`` ``MarkovLM`` prompts of lo-hi tokens from ``seed``."""
    import numpy as np
    from repro_torch.data import MarkovLM
    lm = MarkovLM(vocab_size=vocab, seed=7)
    rs = np.random.RandomState(seed)
    return [lm.sample(rs, 1, rs.randint(lo, hi + 1))[0] for _ in range(n)]


def hyb_key(prompt) -> int:
    import numpy as np
    import zlib
    return zlib.crc32(np.asarray(prompt, np.int64).tobytes())


def hyb_z(dbm, prompt, positions, device) -> torch.Tensor:
    """The initial z of the steps that commit ``prompt``'s request at
    ``positions``: σ_max · N(0, 1) seeded by (prompt, position), so a
    request's tokens do not depend on its slot, batcher or schedule."""
    d = dbm.cfg.d_model
    z = torch.stack([torch.randn(d, generator=torch.Generator().manual_seed(
        hyb_key(prompt) * 8192 + int(p))) for p in positions])
    return (dbm.db.sigma_max * z).to(device)


def hyb_keyed_draws(cb):
    """A batcher's ``draw_segment`` with ``hyb_z``'s draws. It reaches the
    batcher weakly (see ``cb_timed``)."""
    ref = weakref.ref(cb)

    def draw(n):
        b = ref()
        z = torch.zeros((n, b.num_slots, 1, b.dbm.cfg.d_model),
                        device=b.device)
        for s, req in enumerate(b.slot_req):
            if req is not None:
                at = int(b.lengths[s])
                z[:, s, 0] = hyb_z(b.dbm, req.prompt, range(at, at + n),
                                   b.device)
        return z, None
    return draw


def hyb_bounds(dbm, params, plens) -> dict:
    """Least device time of the static run from its shapes (larger of bytes
    over 3.35 TB/s and flops over the fp32 peak: the hybrid computes in
    fp32 under the bf16 policy). A decode step: the probes (every block
    once, so every unit once) read the Mamba layers' fp32 weights with
    their AdaLN heads and the shared block's at each of its n_units
    applications, the commit reads them again without the AdaLN heads,
    plus the head once and the σ-MLP once a block; the Mamba h rows are
    read by the probes and read and written by the commit (conv rows
    beside them); both passes read every slot's committed K/V (bf16) at
    every application. A prefill chunk reads the commit's weights once and
    computes every padded token; the rows are read and written."""
    cfg, B, m = dbm.cfg, BATCH, dbm.model
    mamba = params["units"]["mamba"]
    n_mamba = sum(t.numel() for _, t in _leaves(mamba))
    m_adaln = sum(t.numel() for _, t in _leaves(mamba["adaln"]))
    shared = sum(t.numel() for _, t in _leaves(params["shared"]))
    s_adaln = sum(t.numel() for _, t in _leaves(params["shared"]["adaln"]))
    head = params["head"]["w"].numel()
    cond = sum(t.numel() for _, t in _leaves(params["cond"]))
    probe_w = (n_mamba + m.n_units * shared) * 4
    commit_w = (n_mamba - m_adaln + m.n_units * (shared - s_adaln)) * 4
    d_in = cfg.ssm.expand * cfg.d_model
    H = d_in // cfg.ssm.head_dim
    rows = cfg.n_layers * B * (H * cfg.ssm.head_dim * cfg.ssm.d_state
                               + (cfg.ssm.d_conv - 1)
                               * (d_in + 2 * cfg.ssm.d_state)) * 4
    kv_row = 2 * cfg.n_kv_heads * cfg.head_dim * 2
    mean_len = float(sum(plens)) / B + (HYB_NEW - 1) / 2
    keys = min(mean_len, cfg.sliding_window)
    attn_bytes = 2 * m.n_units * B * keys * kv_row
    attn_flops = 2 * m.n_units * B * keys * cfg.n_heads * cfg.head_dim * 4
    dec_bytes = (probe_w + commit_w + head * 4 + dbm.num_blocks * cond * 4
                 + 3 * rows + attn_bytes)
    dec = bound(dec_bytes, 2 * B * (probe_w + commit_w + head * 4) / 4
                + attn_flops, PEAK_FP32)
    n_chunks = -(-PROMPT // CHUNK)
    pre = bound(n_chunks * (commit_w + 2 * rows)
                + m.n_units * B * PROMPT * kv_row,
                2 * (commit_w / 4) * B * n_chunks * CHUNK, PEAK_FP32)
    return {"prefill_ms": pre[0], "prefill_by": pre[1],
            "decode_step_ms": dec[0], "decode_step_by": dec[1],
            "decode_bytes": {"probe weights": probe_w,
                             "commit weights": commit_w,
                             "state rows": 3 * rows, "pages": attn_bytes,
                             "head and sigma-MLP": head * 4
                             + dbm.num_blocks * cond * 4}}


def hyb_finite(tag: str, kv) -> None:
    for name, t in (("mamba h", kv["mamba"]["h"]),
                    ("mamba conv", kv["mamba"]["conv"]),
                    ("shared k", kv["shared_kv"].k),
                    ("shared v", kv["shared_kv"].v)):
        if not torch.isfinite(t.float()).all():
            raise SmokeError(f"{tag}: non-finite {name} after serving")


def hyb_static(dev, model) -> dict:
    """The static engine over 8 ``MarkovLM`` requests (prompts padded to
    512, ragged 128-512), chunk 64, HYB_NEW new tokens: wall, TTFT, chunk
    and decode-step ms beside the bound; then 4 more decode steps from a
    fresh prefill under the profiler, for the device's busy share."""
    import numpy as np
    from repro_torch import kernels as K
    from repro_torch.launch.serve import get_engine
    from repro_torch.nn import cache as KVC
    dbm, params, gen = model
    cfg = dbm.cfg
    A, G = paged_layers(dbm)
    prompts = np.stack([hyb_prompts(cfg.vocab_size, 1, PROMPT, PROMPT,
                                    seed)[0] for seed in range(BATCH)])
    _, plens = prompts_np(cfg.vocab_size)
    eng = get_engine(dbm, precision="bf16", chunk_size=CHUNK)
    # warm-up at the same shapes, 2 tokens (cuBLAS heuristics, allocator)
    eng.generate(params, prompts, 2, prompt_lengths=plens, generator=gen)
    eng.last_kv = None
    z, _ = eng.draw(HYB_NEW, BATCH, gen, dev)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.generate(params, prompts, HYB_NEW, prompt_lengths=plens, z0=z)
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    tim = eng.last_timing
    n_chunks = -(-PROMPT // CHUNK)
    check_counts("hybrid static", counts, expected_counts(
        flash_decode=HYB_NEW * 2 * A, gate_residual=HYB_NEW * G,
        flash_prefill=n_chunks * A))
    hyb_finite("hybrid static", eng.last_kv)
    eng.last_kv = None
    got = torch.stack([out[b, p:p + HYB_NEW] for b, p in enumerate(plens)])
    if not ((got >= 0) & (got < cfg.vocab_size)).all():
        raise SmokeError("hybrid static: token outside the vocabulary")
    # the device's busy share of 4 decode steps past a fresh prefill
    pps = KVC.pages_for(PROMPT + HYB_NEW, PSZ)
    kv = dbm.model.init_paged_cache(BATCH, 1 + BATCH * pps, PSZ, eng.pol,
                                    device=dev)
    table = KVC.identity_page_table(BATCH, pps, device=dev)
    pl = torch.as_tensor(plens, dtype=torch.int32, device=dev)
    K.reset_launch_counts()
    _, lens = eng.run_prefill(params, kv, table,
                              torch.zeros(BATCH, dtype=torch.int32,
                                          device=dev),
                              torch.as_tensor(prompts, device=dev), pl)
    pwall, busy, top = device_busy(lambda: eng.decode(
        params, kv, table, lens, pl + HYB_NEW, 4, generator=gen), top=8)
    more = K.launch_counts()
    check_counts("hybrid static, profiled", more, expected_counts(
        flash_decode=4 * 2 * A, gate_residual=4 * G,
        flash_prefill=n_chunks * A))
    add_counts(counts, more)
    del kv
    decode_ms = (tim["total_ms"] - tim["prefill_ms"]) / HYB_NEW
    lb = hyb_bounds(dbm, params, plens)
    say(f"[hybrid] static: bf16 policy (fp32 compute, bf16 pages, fp32 "
        f"Mamba rows), greedy, {BATCH} MarkovLM requests, prompts padded to "
        f"{PROMPT} (lengths {plens.tolist()}), chunk {CHUNK}, {HYB_NEW} new "
        "tokens")
    say(f"[hybrid] static: wall {wall:.3f} s | {BATCH * HYB_NEW / wall:.1f} "
        f"tok/s | ttft {tim['ttft_ms']:.1f} ms (prefill "
        f"{tim['prefill_ms']:.1f} ms: {tim['prefill_ms'] / n_chunks:.1f} ms "
        f"a chunk) | decode {decode_ms:.2f} ms/step | bound from the "
        f"shapes: chunk {lb['prefill_ms'] / n_chunks:.2f} ms "
        f"({lb['prefill_by']}), decode {lb['decode_step_ms']:.2f} ms/step "
        f"({lb['decode_step_by']}; "
        + ", ".join(f"{k} {v / 1e9:.2f} GB"
                    for k, v in lb["decode_bytes"].items()) + ")")
    say(f"[hybrid] static: 4 decode steps under the profiler: device busy "
        f"{busy:.1f} ms of {pwall:.1f} ms ({100 * busy / pwall:.1f}%)")
    for ms, count, key in top:
        say(f"[hybrid]   {ms:8.2f} ms  x{count:<6d} {key[:90]}")
    say(f"[hybrid] static: launches {counts} (each run: 2 x {A} paged "
        f"decodes and {G} gate-residuals a step, {A} prefills a chunk)")
    return {"counts": counts, "wall_s": wall, "ttft_ms": tim["ttft_ms"],
            "chunk_ms": tim["prefill_ms"] / n_chunks,
            "decode_ms_per_step": decode_ms, "busy": busy / pwall,
            "bounds": lb}


def hyb_snapshot(cb, reqs) -> tuple:
    """(each request's tokens so far, each slot's committed K/V rows of
    every unit in logical order, the Mamba rows): what the graph-against-
    eager check holds bit-equal. K/V by table and length: the batchers'
    free lists differ, and a page's tail past the length holds whatever
    the page held before."""
    from repro_torch.nn import cache as KVC
    sk = cb.kv["shared_kv"]
    pages = []
    for s in range(cb.num_slots):
        n = int(cb.lengths[s])
        ids = torch.as_tensor(cb.table[s, :KVC.pages_for(n, PSZ)],
                              dtype=torch.long, device=sk.k.device)
        for t in (sk.k, sk.v):
            rows = t.index_select(1, ids)
            pages.append(rows.reshape(rows.shape[0], -1,
                                      *rows.shape[3:])[:, :n])
    return ([list(r.out) for r in reqs], pages,
            [t.clone() for t in cb.kv["mamba"].values()])


def hyb_continuous(dev, model) -> dict:
    """The graphed batcher on 8 slots over CB_REQUESTS ``MarkovLM`` prompts
    of CB_MIN-CB_MAX tokens, HYB_NEW new each (draws keyed by prompt and
    position, ``hyb_z``); then on the same batcher the first 8 prompts
    again for HYB_CHECK_SEGMENTS segments against an eager batcher (tokens,
    pages, Mamba rows bit-equal), one of them spilled through the wire
    bytes and restored, all 8 finishing with the first run's tokens; and
    request CB_SLOTS (the first in a recycled slot) served alone by the
    static engine under its draws, with the same tokens."""
    import numpy as np
    from repro_torch import kernels as K
    from repro_torch.launch.serve import get_engine
    from repro_torch.nn import cache as KVC
    dbm, params, _ = model
    prompts = hyb_prompts(dbm.cfg.vocab_size, CB_REQUESTS, CB_MIN, CB_MAX, 1)
    K.reset_launch_counts()
    cb = cb_batcher(dev, model, prefix_cache=False)
    cb.draw_segment = hyb_keyed_draws(cb)
    t0 = time.perf_counter()
    cb.capture()
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    events = cb_timed(cb)
    for p in prompts:
        cb.submit(p, HYB_NEW)
    reqs = list(cb.queue)
    t0 = time.perf_counter()
    cb.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bad = [r.rid for r in reqs if len(r.out) != HYB_NEW or r.error]
    if bad or cb.page_refs or len(cb.free_pages) != cb.total_pages - 1:
        raise SmokeError(f"hybrid continuous: short or failed {bad}, pages "
                         f"{len(cb.free_pages)} free of {cb.total_pages - 1}")
    first = [list(r.out) for r in reqs]
    seg_ms = [s.elapsed_time(e) for s, e in events["segment"]]
    chunk_ms = [s.elapsed_time(e) for s, e in events["chunk"]]
    in_dispatch = (sum(seg_ms) + sum(chunk_ms)) / (wall * 1e3)
    ttft = sorted(r.ttft for r in reqs)
    n_tok = sum(len(r.out) for r in reqs)
    state_mb = sum(t.numel() * t.element_size()
                   for t in cb.kv["mamba"].values()) / 1e6
    pool_mb = sum(t.numel() * t.element_size()
                  for t in pool_tensors(cb.kv["shared_kv"])) / 1e6
    say(f"[hybrid] continuous: {CB_REQUESTS} requests of {CB_MIN}-{CB_MAX} "
        f"tokens on {CB_SLOTS} slots, bf16 policy, greedy, page {PSZ}, "
        f"chunk {CHUNK}, seg_len {CB_SEG}, {HYB_NEW} new tokens each, no "
        f"prefix cache (refused for the family); both dispatches replayed "
        f"from graphs captured in {capture_s:.2f} s (warm-ups "
        f"{cb.graph_warmups}); Mamba rows {state_mb:.1f} MB, pages "
        f"{pool_mb:.1f} MB")
    say(f"[hybrid] continuous: wall {wall:.3f} s | {n_tok / wall:.1f} tok/s "
        f"| TTFT median {statistics.median(ttft) * 1e3:.1f} ms, max "
        f"{ttft[-1] * 1e3:.1f} ms | decode {sum(seg_ms) / cb.steps:.3f} ms "
        f"per segment step ({len(seg_ms)} segments) | chunk dispatch "
        f"{statistics.median(chunk_ms):.2f} ms median ({len(chunk_ms)}) | "
        f"inside a dispatch {100 * in_dispatch:.1f}% of the wall (CUDA "
        f"events)")
    stats = {"wall_s": wall, "tok_s": n_tok / wall,
             "ttft_median_s": statistics.median(ttft),
             "segment_step_ms": sum(seg_ms) / max(1, cb.steps),
             "chunk_ms_median": statistics.median(chunk_ms),
             "in_dispatch": in_dispatch, "capture_s": capture_s}
    del events, cb._decode_segment, cb._chunk     # cb_timed's wrappers

    # graph against eager over the first segments of the first 8 prompts
    eager = cb_batcher(dev, model, prefix_cache=False, graphs=False)
    eager.draw_segment = hyb_keyed_draws(eager)
    snaps, again = [], None
    for b in (cb, eager):
        d0 = b.decode_dispatches
        for p in prompts[:CB_SLOTS]:
            b.submit(p, HYB_NEW)
        sub = list(b.queue)
        again = again or sub
        while b.decode_dispatches < d0 + HYB_CHECK_SEGMENTS:
            b.step()
        torch.cuda.synchronize()
        snaps.append(hyb_snapshot(b, sub))
    (tg, pg, rg), (te, pe, re_) = snaps
    equal = (tg == te and all(torch.equal(a, b) for a, b in zip(pg, pe))
             and all(torch.equal(a, b) for a, b in zip(rg, re_)))
    say(f"[hybrid] continuous: graph vs eager, first {HYB_CHECK_SEGMENTS} "
        f"segments of {CB_SLOTS} requests: tokens "
        f"{'identical' if tg == te else 'DIFFER'} ({sum(map(len, tg))} "
        f"tokens), pages and Mamba rows "
        f"{'bit-equal' if equal else 'DIFFER'}")
    if not equal or not sum(map(len, tg)):
        raise SmokeError("hybrid continuous: the graphs' dispatches differ "
                         "from the eager ones")
    ledger = [srv_ledger(eager)]
    del eager, snaps, pg, pe, rg, re_

    # preemption through the wire bytes, then to the end
    s = next((s for s in range(cb.num_slots) if cb.active[s]
              and cb.lengths[s] >= cb.plens[s]), None)
    if s is None:
        raise SmokeError("hybrid continuous: no slot decoding to preempt")
    with cb._pool_lock:
        req = cb._preempt_slot(s)
    raw = req.spilled.to_bytes()
    req.spilled = KVC.SpilledSlot.from_bytes(raw)
    rows_mb = sum(e.numel() * e.element_size() for e in req.spilled.data
                  if not isinstance(e, tuple)) / 1e6
    n_pages = req.spilled.n_pages
    cb.run()
    torch.cuda.synchronize()
    ledger.append(srv_ledger(cb))
    resumed = [list(r.out) for r in again]
    say(f"[hybrid] continuous: request {req.rid} spilled from slot {s} "
        f"mid-decode ({len(raw) / 1e6:.1f} MB of wire bytes: "
        f"{n_pages} pages of {dbm.model.n_units} units and "
        f"{rows_mb:.1f} MB of Mamba rows) and restored; the 8 requests "
        f"{'equal' if resumed == first[:CB_SLOTS] else 'DIFFER FROM'} the "
        f"first run's tokens (preemptions {cb.preemptions}, restores "
        f"{cb.restores})")
    if resumed != first[:CB_SLOTS] or cb.restores != 1:
        raise SmokeError("hybrid continuous: the restored run's tokens "
                         "differ from the uninterrupted run's")
    counts = K.launch_counts()
    check_counts("hybrid continuous", counts, srv_counts(ledger))
    del cb, req, raw
    torch.cuda.empty_cache()

    # request CB_SLOTS (admitted into a recycled slot) alone
    p = prompts[CB_SLOTS]
    eng = get_engine(dbm, precision="bf16", chunk_size=CHUNK)
    z = hyb_z(dbm, p, range(len(p), len(p) + HYB_NEW), dev)
    K.reset_launch_counts()
    solo = eng.generate(params, np.asarray(p)[None], HYB_NEW,
                        z0=z[:, None, None])
    eng.last_kv = None
    A, G = paged_layers(dbm)
    more = K.launch_counts()
    check_counts("hybrid solo", more, expected_counts(
        flash_decode=HYB_NEW * 2 * A, gate_residual=HYB_NEW * G,
        flash_prefill=-(-len(p) // CHUNK) * A))
    add_counts(counts, more)
    solo_out = solo[0, len(p):].tolist()
    say(f"[hybrid] continuous: request {CB_SLOTS} (a recycled slot's "
        f"second request, {len(p)} prompt tokens) served alone by the "
        f"static engine under its draws: tokens "
        f"{'equal' if solo_out == first[CB_SLOTS] else 'DIFFER'}")
    if solo_out != first[CB_SLOTS]:
        raise SmokeError("hybrid continuous: a recycled slot's request "
                         "differs from its solo run")
    return {"counts": counts, **stats}


def hyb_fp32_check(dev) -> dict:
    """HYB_CUT_UNITS units (6 Mamba layers, 2 applications of the shared
    block) at full width in 2 blocks, fp32 policy: one MarkovLM prompt of
    HYB_LONG tokens (the 4096-token window bites in the last chunks and in
    every decode step) through the static engine, through the kernels and
    through ``impl="ref"`` under the same draws; every step's logits within
    1e-3 relative and the greedy tokens equal."""
    import numpy as np
    from repro_torch import kernels as K
    from repro_torch.launch.serve import get_engine
    model = hyb_model(dev, n_units=HYB_CUT_UNITS, blocks=2)
    dbm, params, gen = model
    A, G = paged_layers(dbm)
    prompt = np.asarray(hyb_prompts(dbm.cfg.vocab_size, 1, HYB_LONG,
                                    HYB_LONG, 2)[0])[None]
    z, _ = get_engine(dbm, precision="fp32", chunk_size=CHUNK).draw(
        HYB_LONG_NEW, 1, gen, dev)
    plain = dbm.model.logits
    runs = {}
    for impl in ("kernels", "ref"):
        logits = []

        def readout(p, h, logits=logits):
            logits.append(plain(p, h))
            return logits[-1]
        dbm.model.logits = readout
        K.reset_launch_counts()
        try:
            eng = get_engine(dbm, precision="fp32", impl=impl,
                             chunk_size=CHUNK)
            out = eng.generate(params, prompt, HYB_LONG_NEW, z0=z)
            eng.last_kv = None
        finally:
            del dbm.model.logits
        runs[impl] = (out, torch.stack([x[:, 0].float() for x in logits]),
                      K.launch_counts())
    counts = runs["kernels"][2]
    check_counts("hybrid fp32", counts, expected_counts(
        flash_decode=HYB_LONG_NEW * 2 * A, gate_residual=HYB_LONG_NEW * G,
        flash_prefill=-(-HYB_LONG // CHUNK) * A))
    check_counts("hybrid fp32, plain", runs["ref"][2], expected_counts())
    lk, lr = runs["kernels"][1], runs["ref"][1]
    rel = ((lk - lr).abs().max() / lr.abs().max()).item()
    equal = torch.equal(runs["kernels"][0], runs["ref"][0])
    say(f"[hybrid] fp32 depth cut ({HYB_CUT_UNITS} units: "
        f"{dbm.cfg.n_layers} Mamba layers and {HYB_CUT_UNITS} applications "
        f"of the shared block, 2 blocks, full width), one prompt of "
        f"{HYB_LONG} tokens (window {dbm.cfg.sliding_window}), "
        f"{HYB_LONG_NEW} new tokens, kernels vs plain versions: logits rel "
        f"max|diff| {rel:.2e} (limit 1e-3) | greedy tokens "
        f"{'equal' if equal else 'DIFFER'}")
    if not (rel <= 1e-3 and math.isfinite(rel)) or not equal:
        raise SmokeError(f"hybrid fp32 cross-check: logits {rel:.2e}, "
                         f"tokens equal {equal}")
    return {"counts": counts, "logits_rel": rel}


def phase_hybrid(dev) -> dict:
    """Phase 16: zamba2-7b at full width (see the module docstring). Runs
    after phase 15 under its memory checks: the fp32 masters alone are
    39.86 GB."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    clear_cublas_workspaces()
    base = torch.cuda.memory_allocated()
    say(f"[hybrid] memory allocated at the phase's start: "
        f"{base / 2**30:.3f} GiB")
    if base > HYB_MEM_START:
        raise SmokeError(f"hybrid: {base / 2**30:.2f} GiB still allocated "
                         "from earlier phases")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = hyb_model(dev)
    dbm, params, _ = model
    torch.cuda.synchronize()
    cfg, m = dbm.cfg, dbm.model
    n_params = sum(t.numel() for _, t in _leaves(params))
    say(f"[hybrid] {cfg.name}: {cfg.n_layers} Mamba2 layers in {m.n_units} "
        f"units of {m.inner}, each followed by the shared attention + MLP "
        f"block; d={cfg.d_model} heads={cfg.n_heads} kv={cfg.n_kv_heads} "
        f"hd={cfg.head_dim} ff={cfg.d_ff} window={cfg.sliding_window} "
        f"vocab={cfg.vocab_size}, SSM d_state {cfg.ssm.d_state} head_dim "
        f"{cfg.ssm.head_dim} expand {cfg.ssm.expand}; {dbm.num_blocks} "
        f"blocks {dbm.ranges}; {n_params / 1e9:.3f} B params fp32 (reckoned "
        f"9.964 B) made in {time.perf_counter() - t0:.1f} s")
    counts = {}
    static = hyb_static(dev, model)
    add_counts(counts, static["counts"])
    cont = hyb_continuous(dev, model)
    add_counts(counts, cont["counts"])
    peak = torch.cuda.max_memory_allocated()
    say(f"[hybrid] peak memory at full width {peak / 2**30:.2f} GiB "
        f"(reckoned: 39.86 GB fp32 masters served as they are, about 1.25 "
        f"GB of Mamba rows and 1.7 GB of pages a batcher, plus transients: "
        f"near 44 GiB) of "
        f"{torch.cuda.get_device_properties(dev).total_memory / 2**30:.1f}")
    del model, dbm, params, m
    torch.cuda.empty_cache()
    fp32 = hyb_fp32_check(dev)
    add_counts(counts, fp32["counts"])
    torch.cuda.empty_cache()
    clear_cublas_workspaces()
    left = torch.cuda.memory_allocated()
    say(f"[hybrid] with everything dropped (no gc pass): "
        f"{left / 2**30:.3f} GiB allocated against {base / 2**30:.3f} GiB "
        "at the start")
    if left - base > HYB_MEM_SLACK:
        raise SmokeError(f"hybrid: {(left - base) / 2**30:.2f} GiB left "
                         "allocated after the phase")
    took = time.perf_counter() - t_phase
    say(f"[hybrid] phase 16 took {took:.1f} s | launches {counts}")
    return {"counts": counts, "static": static, "continuous": cont,
            "peak": peak, "fp32_rel": fp32["logits_rel"], "seconds": took}


# ---------------------------------------------------------------------------
# 17. the hybrid's training: zamba2-7b at full width
# ---------------------------------------------------------------------------

def finite_step(tag, loss, m) -> None:
    if not (math.isfinite(float(loss))
            and math.isfinite(float(m["grad_norm"]))):
        raise SmokeError(f"{tag}: loss {float(loss)}, grad norm "
                         f"{float(m['grad_norm'])}")


def unit_stack(dbm) -> str:
    """The name of the params' stacked units: the hybrid's and the VLM's
    ``units``, else ``layers``."""
    return "units" if "units" in dbm.model.spec else "layers"


def resident_db_steps(dbm, params, gen, tcfg, data, tag: str,
                      aux=None) -> dict:
    """Every block's AdamW state made up front and kept, as ``train_db``
    keeps them; a warm-up step on the last block (first-call costs), then
    one timed DB step on each block, bf16 policy, and one more on block 0
    under the profiler. Each step's launches must equal the path's
    arithmetic, its loss and grad norm be finite, and only its block's
    units and the rest (periphery, the hybrid's shared block, the
    encoder-decoder's encoder) change. ``aux()``, where given, makes each
    step's ``aux_inputs``."""
    from repro_torch.core import training as T
    dev = params["embed"]["table"].device
    stack = unit_stack(dbm)
    batch = lambda: torch.as_tensor(next(data), device=dev)  # noqa: E731
    kw = lambda: {} if aux is None else {"aux_inputs": aux()}  # noqa: E731
    t0 = time.perf_counter()
    steps = [T.make_db_train_step(dbm, b, tcfg, precision="bf16")
             for b in range(dbm.num_blocks)]
    states = [init(params) for init, _ in steps]
    torch.cuda.synchronize()
    state_bytes = sum(x.numel() * x.element_size() for st in states
                      for tree in (st.mu, st.nu) for _, x in _leaves(tree))
    say(f"[{tag}] {dbm.num_blocks} AdamW states made in "
        f"{time.perf_counter() - t0:.1f} s: {state_bytes / 2**30:.2f} GiB; "
        f"resident "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    last = dbm.num_blocks - 1
    _, states[last], loss, m = steps[last][1](params, states[last], batch(),
                                              gen, **kw())
    finite_step(f"{tag} warm-up DB step", loss, m)
    say(f"[{tag}] warm-up DB step on block {last}: loss {float(loss):.4f}")
    out = {"db": [], "launches": {}}
    for b, (start, size) in enumerate(dbm.ranges):
        before = unit_digests(params, stack)
        tokens, extra = batch(), kw()
        (res, wall, dev_ms, peak, base, counts) = timed_step(
            lambda: steps[b][1](params, states[b], tokens, gen, **extra))
        _, states[b], loss, m = res
        del res
        changed = (unit_digests(params, stack) != before).tolist()
        expect = db_step_counts(dbm, size)
        say(f"[{tag}] DB step block {b} ({stack} {start}-"
            f"{start + size - 1}): loss {float(loss):.4f}{router_aux(dbm, m)}"
            f" | grad norm "
            f"{float(m['grad_norm']):.3f} | wall {wall * 1e3:.1f} ms | "
            f"device {dev_ms:.1f} ms (events) | peak {peak / 2**30:.2f} GiB "
            f"(resident before {base / 2**30:.2f}: masters + every block's "
            f"AdamW state) | launches {counts}")
        check_counts(f"{tag} DB step block {b}", counts, expect)
        finite_step(f"{tag} DB step block {b}", loss, m)
        want = [start <= u < start + size
                for u in range(len(before) - 1)] + [True]
        if changed != want:
            raise SmokeError(f"{tag} DB step block {b} changed units "
                             f"{changed} (expected {want})")
        add_counts(out["launches"], counts)
        out["db"].append({"block": b, "loss": float(loss), "wall_s": wall,
                          "device_ms": dev_ms, "peak_bytes": peak,
                          "resident_bytes": base})
    walls = [r["wall_s"] * 1e3 for r in out["db"]]
    say(f"[{tag}] DB step wall over the {len(walls)} blocks: median "
        f"{statistics.median(walls):.1f} ms, min-max {min(walls):.1f}-"
        f"{max(walls):.1f} ms")
    tokens, extra = batch(), kw()
    out["db_profile"] = profile_step(
        f"{tag}: DB step block 0",
        lambda: steps[0][1](params, states[0], tokens, gen, **extra))
    del states, steps
    return out


def router_aux(dbm, m) -> str:
    """`` | router aux x`` for a MoE step's metrics, else ``""``."""
    return f" | router aux {float(m['aux']):.4f}" if dbm.cfg.moe else ""


def e2e_steps(dbm, params, tcfg, data, tag: str, aux=None) -> dict:
    """The end-to-end step over every unit (one AdamW state over every
    param), bf16 policy: a warm-up step, a timed one, one under the
    profiler. ``aux()``, where given, makes each step's
    ``aux_inputs``."""
    from repro_torch.core import training as T
    dev = params["embed"]["table"].device
    batch = lambda: torch.as_tensor(next(data), device=dev)  # noqa: E731
    kw = lambda: {} if aux is None else {"aux_inputs": aux()}  # noqa: E731
    init, step = T.make_e2e_train_step(dbm, tcfg, precision="bf16")
    opt = init(params)
    loss = step(params, opt, batch(), **kw())[2]
    say(f"[{tag}] warm-up e2e step: loss {float(loss):.4f}")
    tokens, extra = batch(), kw()
    (res, wall, dev_ms, peak, base, counts) = timed_step(
        lambda: step(params, opt, tokens, **extra)[2:])
    loss, m = res
    stack = unit_stack(dbm)
    n = dbm.model.n_units if stack == "units" else dbm.cfg.n_layers
    say(f"[{tag}] e2e step ({n} {stack}, batch {tokens.shape[0]}x"
        f"{tokens.shape[1]}): loss {float(loss):.4f}{router_aux(dbm, m)} | "
        f"grad norm "
        f"{float(m['grad_norm']):.3f} | wall {wall * 1e3:.1f} ms | device "
        f"{dev_ms:.1f} ms (events) | peak {peak / 2**30:.2f} GiB (resident "
        f"before {base / 2**30:.2f}: masters + AdamW state of every param) "
        f"| launches {counts}")
    check_counts(f"{tag} e2e step", counts, e2e_counts(dbm))
    finite_step(f"{tag} e2e step", loss, m)
    tokens, extra = batch(), kw()
    prof = profile_step(f"{tag}: e2e step",
                        lambda: step(params, opt, tokens, **extra))
    del opt
    return {"loss": float(loss), "wall_s": wall, "device_ms": dev_ms,
            "peak_bytes": peak, "resident_bytes": base, "launches": counts,
            "profile": prof}


def phase_hybrid_train(dev) -> dict:
    """Phase 17: zamba2-7b trained at full width, after phase 16 under its
    memory checks. The depth is cut in whole units to HYB_TRAIN_UNITS (24
    Mamba layers, 8 applications of the shared block) in HYB_TRAIN_BLOCKS
    blocks; random fp32 weights from seed 0 with the AdaLN heads
    randomised. ``resident_db_steps`` at HYB_DB_BATCH x 512 ``MarkovLM``
    tokens (``block_loss`` takes the two-pass route for the family), then
    ``e2e_steps`` at HYB_E2E_BATCH x 512; then, the model dropped, one
    fp32 DB step of HYB_CHECK_UNITS units through the kernels against
    ``impl="ref"``; memory back within HYB_TRAIN_SLACK."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import MarkovLM
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    clear_cublas_workspaces()
    base = torch.cuda.memory_allocated()
    say(f"[hybrid-train] memory allocated at the phase's start: "
        f"{base / 2**30:.3f} GiB")
    if base > HYB_MEM_START:
        raise SmokeError(f"hybrid training: {base / 2**30:.2f} GiB still "
                         "allocated from earlier phases")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dbm, params, gen = hyb_model(dev, n_units=HYB_TRAIN_UNITS,
                                 blocks=HYB_TRAIN_BLOCKS)
    torch.cuda.synchronize()
    cfg, m = dbm.cfg, dbm.model
    n_params = sum(t.numel() for _, t in _leaves(params))
    say(f"[hybrid-train] {cfg.name} at full width, depth cut to "
        f"{m.n_units} units ({cfg.n_layers} Mamba2 layers, {m.n_units} "
        f"applications of the shared block; hd {cfg.head_dim}, window "
        f"{cfg.sliding_window}, SSM chunk {cfg.ssm.chunk_size}), "
        f"{dbm.num_blocks} blocks {dbm.ranges}, causal_mode "
        f"{dbm.causal_mode}, loss {dbm.db.loss}; {n_params / 1e9:.3f} B "
        f"params fp32 made in "
        f"{time.perf_counter() - t0:.1f} s")
    tcfg = TrainConfig(steps=100, warmup_steps=10, lr=1e-4)
    lm = MarkovLM(vocab_size=cfg.vocab_size, seed=7)
    db = resident_db_steps(dbm, params, gen, tcfg,
                           lm.iterator(HYB_DB_BATCH, TRAIN_SEQ),
                           "hybrid-train")
    torch.cuda.empty_cache()
    db_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    e2e = e2e_steps(dbm, params, tcfg,
                    lm.iterator(HYB_E2E_BATCH, TRAIN_SEQ), "hybrid-train")
    e2e_peak = torch.cuda.max_memory_allocated()
    counts = dict(db["launches"])
    add_counts(counts, e2e["launches"])
    say(f"[hybrid-train] peak memory: DB steps with all "
        f"{dbm.num_blocks} AdamW states {db_peak / 2**30:.2f} GiB, e2e step "
        f"{e2e_peak / 2**30:.2f} GiB of "
        f"{torch.cuda.get_device_properties(dev).total_memory / 2**30:.1f}; "
        f"nvidia-smi (sm MHz, W, limit, C): "
        f"{gpu_query('clocks.sm,power.draw,power.limit,temperature.gpu')}")
    del dbm, params, gen, m
    torch.cuda.empty_cache()
    check = hyb_model(dev, n_units=HYB_CHECK_UNITS, blocks=1)
    cross = db_crosscheck(
        dev, check, "hybrid two-pass ce",
        [("mamba", "mixer", "in_proj", "w"), ("mamba", "mixer", "a_log"),
         ("mamba", "adaln", "w")], stack="units",
        whole=[("shared", "attn", "wq"), ("shared", "adaln", "w")],
        batch=HYB_DB_BATCH)
    del check
    torch.cuda.empty_cache()
    clear_cublas_workspaces()
    left = torch.cuda.memory_allocated()
    say(f"[hybrid-train] with everything dropped (no gc pass): "
        f"{left / 2**30:.3f} GiB allocated against {base / 2**30:.3f} GiB "
        "at the start")
    if left - base > HYB_TRAIN_SLACK:
        raise SmokeError(f"hybrid training: {(left - base) / 2**30:.2f} GiB "
                         "left allocated after the phase")
    took = time.perf_counter() - t_phase
    say(f"[hybrid-train] phase 17 took {took:.1f} s | launches {counts}")
    return {"counts": counts, "db": db, "e2e": e2e, "db_peak": db_peak,
            "e2e_peak": e2e_peak, "crosscheck": cross, "seconds": took}


# ---------------------------------------------------------------------------
# 18. h2o-danube3-4b: served and trained at full width
# ---------------------------------------------------------------------------

def h2o_model(dev, n_layers=None, blocks=None, **db):
    """h2o-danube3-4b (cut to ``n_layers`` where given) in DEFAULT_DB's
    blocks (or ``blocks``; ``db``: other DBConfig fields), random fp32
    weights from seed 0, the AdaLN heads randomised. Returns (dbm, params,
    gen)."""
    from repro_torch.configs import DEFAULT_DB, get_config
    from repro_torch.core.blocks import DiffusionBlocksModel
    cfg = get_config(H2O_ARCH)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    dbm = DiffusionBlocksModel(cfg, dataclasses.replace(
        DEFAULT_DB, num_blocks=blocks or DEFAULT_DB.num_blocks, **db))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = dbm.init(gen)
    for k in ("w", "b"):
        params["layers"]["adaln"][k].normal_(0.0, 0.02, generator=gen)
    return dbm, params, gen


def two_pass_view(model):
    """The same params under DBConfig(causal_mode="two_pass", loss="l2")."""
    from repro_torch.core.blocks import DiffusionBlocksModel
    dbm, params, gen = model
    return (DiffusionBlocksModel(dbm.cfg, dataclasses.replace(
        dbm.db, causal_mode="two_pass", loss="l2")), params, gen)


def queue_serve(dev, model, tag: str = "h2o") -> dict:
    """Phase 5b's queue (32 requests on 8 slots, 64 new tokens, the decode
    segments and chunk steps replayed from CUDA graphs) at full width:
    every request served, no page leaked, launches equal to the dispatches'
    arithmetic; with the batcher and the serving copies dropped, at most
    H2O_SERVE_SLACK allocated beyond the masters and no batcher left.
    ``tag`` names the model in the lines it prints."""
    from repro_torch import kernels as K
    from repro_torch.launch.serve import ContinuousBatcher
    dbm, params, _ = model
    prompts, _ = cb_queue(dbm.cfg.vocab_size)
    masters = sum(p.numel() * p.element_size() for _, p in _leaves(params))
    torch.cuda.reset_peak_memory_stats()
    cb = cb_batcher(dev, model)
    t0 = time.perf_counter()
    cb.capture()
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    events = cb_timed(cb)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    for p in prompts:
        cb.submit(p, CB_NEW)
    done = cb.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    cb_drained(f"{tag} continuous", cb, done, CB_REQUESTS)
    check_counts(f"{tag} continuous", counts, cb_counts(dbm, cb))
    seg_ms = [a.elapsed_time(b) for a, b in events["segment"]]
    chunk_ms = [a.elapsed_time(b) for a, b in events["chunk"]]
    seg_step_ms = sum(seg_ms) / cb.steps
    in_dispatch = (sum(seg_ms) + sum(chunk_ms)) / (wall * 1e3)
    ttft = sorted(r.ttft for r in done)
    n_tok = sum(len(r.out) for r in done)
    say(f"[{tag}] continuous, {CB_REQUESTS} requests on {CB_SLOTS} slots "
        f"(phase 5b's queue), bf16, graphs captured in {capture_s:.2f} s: "
        f"wall {wall:.3f} s | {n_tok / wall:.1f} tok/s | TTFT median "
        f"{statistics.median(ttft) * 1e3:.1f} ms, max "
        f"{ttft[-1] * 1e3:.1f} ms | decode {seg_step_ms:.3f} ms per "
        f"segment step ({len(seg_ms)} segments) | chunk dispatch "
        f"{statistics.median(chunk_ms):.2f} ms median ({len(chunk_ms)}) | "
        f"inside a dispatch {100 * in_dispatch:.1f}% of the wall | peak "
        f"{peak / 2**30:.2f} GiB | launches {counts} | nvidia-smi (sm MHz, "
        f"W, limit, C): "
        f"{gpu_query('clocks.sm,power.draw,power.limit,temperature.gpu')}")
    del cb, done
    dbm.__dict__.pop("_compute_copies", None)     # serving's bf16 copy
    dbm.model.__dict__.pop("_unit_memo", None)
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() - masters
    stray = sum(isinstance(o, ContinuousBatcher) for o in gc.get_objects())
    say(f"[{tag}] after serving: {left / 2**30:.3f} GiB allocated beyond the "
        f"{masters / 2**30:.2f} GiB of masters, {stray} batchers in memory")
    if left > H2O_SERVE_SLACK or stray:
        raise SmokeError(f"{tag} serving left {left / 2**30:.2f} GiB beyond "
                         f"the masters and {stray} batchers")
    return {"counts": counts, "wall_s": wall, "tok_s": n_tok / wall,
            "segment_step_ms": seg_step_ms, "in_dispatch": in_dispatch,
            "chunk_ms_median": statistics.median(chunk_ms),
            "ttft_median_s": statistics.median(ttft), "peak_bytes": peak,
            "capture_s": capture_s}


def two_pass_step(model, tcfg, data, tag: str, aux=None,
                  profile: bool = True) -> dict:
    """One DB step of block 0 (its own AdamW state) in the model's causal
    mode and loss (the callers' two_pass x l2, or the xLSTM's two_pass x
    ce at a longer sequence): a warm-up, a timed step (launches against
    the path's arithmetic, finite loss and grad norm) and one under the
    profiler (where asked). ``aux()``, where
    given, makes each step's ``aux_inputs``."""
    from repro_torch.core import training as T
    dbm, params, gen = model
    dev = params["embed"]["table"].device
    batch = lambda: torch.as_tensor(next(data), device=dev)  # noqa: E731
    kw = lambda: {} if aux is None else {"aux_inputs": aux()}  # noqa: E731
    init, step = T.make_db_train_step(dbm, 0, tcfg, precision="bf16")
    what = f"{dbm.causal_mode} x {dbm.db.loss}"
    state = init(params)
    loss = step(params, state, batch(), gen, **kw())[2]
    say(f"[{tag}] warm-up {what} DB step on block 0: loss "
        f"{float(loss):.4f}")
    tokens, extra = batch(), kw()
    (res, wall, dev_ms, peak, base, counts) = timed_step(
        lambda: step(params, state, tokens, gen, **extra)[2:])
    loss, m = res
    del res
    size = dbm.ranges[0][1]
    say(f"[{tag}] {what} DB step block 0 ({unit_stack(dbm)} 0-"
        f"{size - 1}, batch {tokens.shape[0]}x{tokens.shape[1]}): loss "
        f"{float(loss):.4f}{router_aux(dbm, m)} | grad norm "
        f"{float(m['grad_norm']):.3f} | "
        f"wall {wall * 1e3:.1f} ms | device {dev_ms:.1f} ms (events) | peak "
        f"{peak / 2**30:.2f} GiB (resident before {base / 2**30:.2f}) | "
        f"launches {counts}")
    check_counts(f"{tag} two_pass DB step", counts,
                 db_step_counts(dbm, size))
    finite_step(f"{tag} two_pass DB step", loss, m)
    prof = None
    if profile:
        tokens, extra = batch(), kw()
        prof = profile_step(f"{tag}: {what} DB step block 0",
                            lambda: step(params, state, tokens, gen,
                                         **extra))
    del state
    return {"loss": float(loss), "wall_s": wall, "device_ms": dev_ms,
            "peak_bytes": peak, "launches": counts, "profile": prof}


def phase_h2o(dev) -> dict:
    """Phase 18: h2o-danube3-4b at full width (24 layers, d 3840, 32 query
    heads on 8 KV heads of 120, d_ff 10240, window 4096), after phase 17
    under its memory check. Served at full depth through ``queue_serve``;
    then trained cut to H2O_TRAIN_LAYERS layers in 4 blocks, the bf16
    policy, ``MarkovLM`` batches of TRAIN_BATCH x 512: ``resident_db_steps``
    (concat x CE, all four AdamW states resident), one two_pass x l2 DB
    step of block 0, ``e2e_steps``; then, the model dropped, one fp32 DB
    step of H2O_CHECK_LAYERS layers through the kernels against
    ``impl="ref"`` in concat x CE and in two_pass x l2; memory back within
    1 GiB of the phase's start."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import MarkovLM
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    clear_cublas_workspaces()
    base = torch.cuda.memory_allocated()
    say(f"[h2o] memory allocated at the phase's start: {base / 2**30:.3f} "
        "GiB")
    if base > H2O_MEM_START:
        raise SmokeError(f"h2o: {base / 2**30:.2f} GiB still allocated "
                         "from earlier phases")
    t0 = time.perf_counter()
    model = h2o_model(dev)
    torch.cuda.synchronize()
    dbm = model[0]
    cfg = dbm.cfg
    say(f"[h2o] {cfg.name}: {cfg.n_layers} layers d={cfg.d_model} heads="
        f"{cfg.n_heads} on {cfg.n_kv_heads} KV heads of {cfg.head_dim}, ff="
        f"{cfg.d_ff}, window {cfg.sliding_window}, vocab {cfg.vocab_size}; "
        f"{sum(p.numel() for _, p in _leaves(model[1])) / 1e9:.3f} B params"
        f" fp32 made in {time.perf_counter() - t0:.1f} s")
    serve = queue_serve(dev, model)
    counts = dict(serve["counts"])
    del model, dbm
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    model = h2o_model(dev, n_layers=H2O_TRAIN_LAYERS)
    torch.cuda.synchronize()
    dbm, params, gen = model
    say(f"[h2o-train] depth cut to {H2O_TRAIN_LAYERS} layers, "
        f"{dbm.num_blocks} blocks {dbm.ranges}: "
        f"{sum(p.numel() for _, p in _leaves(params)) / 1e9:.3f} B params "
        f"fp32 made in {time.perf_counter() - t0:.1f} s")
    tcfg = TrainConfig(steps=100, warmup_steps=10, lr=1e-4)
    lm = MarkovLM(vocab_size=cfg.vocab_size, seed=7)
    data = lm.iterator(TRAIN_BATCH, TRAIN_SEQ)
    torch.cuda.reset_peak_memory_stats()
    db = resident_db_steps(dbm, params, gen, tcfg, data, "h2o-train")
    torch.cuda.empty_cache()
    db_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    two_pass = two_pass_step(two_pass_view(model), tcfg, data, "h2o-train")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    e2e = e2e_steps(dbm, params, tcfg, data, "h2o-train")
    e2e_peak = torch.cuda.max_memory_allocated()
    for c in (db["launches"], two_pass["launches"], e2e["launches"]):
        add_counts(counts, c)
    say(f"[h2o-train] peak memory: DB steps with all {dbm.num_blocks} "
        f"AdamW states {db_peak / 2**30:.2f} GiB, two_pass step "
        f"{two_pass['peak_bytes'] / 2**30:.2f} GiB, e2e step "
        f"{e2e_peak / 2**30:.2f} GiB of "
        f"{torch.cuda.get_device_properties(dev).total_memory / 2**30:.1f}; "
        f"nvidia-smi (sm MHz, W, limit, C): "
        f"{gpu_query('clocks.sm,power.draw,power.limit,temperature.gpu')}")
    del model, dbm, params, gen
    torch.cuda.empty_cache()
    check = h2o_model(dev, n_layers=H2O_CHECK_LAYERS, blocks=1)
    grads = [("attn", "wq"), ("attn", "wk"), ("mlp", "wg"), ("adaln", "w")]
    cross = {"concat": db_crosscheck(dev, check, "h2o concat ce", grads),
             "two_pass": db_crosscheck(dev, two_pass_view(check),
                                       "h2o two-pass l2", grads)}
    del check
    torch.cuda.empty_cache()
    clear_cublas_workspaces()
    left = torch.cuda.memory_allocated()
    say(f"[h2o] with everything dropped (no gc pass): {left / 2**30:.3f} "
        f"GiB allocated against {base / 2**30:.3f} GiB at the start")
    if left - base > 2**30:
        raise SmokeError(f"h2o: {(left - base) / 2**30:.2f} GiB left "
                         "allocated after the phase")
    took = time.perf_counter() - t_phase
    say(f"[h2o] phase 18 took {took:.1f} s | launches {counts}")
    return {"counts": counts, "serve": serve, "db": db, "two_pass": two_pass,
            "e2e": e2e, "db_peak": db_peak, "e2e_peak": e2e_peak,
            "crosscheck": cross, "seconds": took}


# ---------------------------------------------------------------------------
# 19. whisper-small: the audio family served and trained at full width
# ---------------------------------------------------------------------------

def w_model(dev, n_layers=None, n_encoder_layers=None, blocks=None, **db):
    """whisper-small (cut to ``n_layers`` decoder and ``n_encoder_layers``
    encoder layers where given) in DEFAULT_DB's blocks (or ``blocks``;
    ``db``: other DBConfig fields), random fp32 weights from seed 0, the
    AdaLN heads randomised. Returns (dbm, params, gen)."""
    from repro_torch.configs import DEFAULT_DB, get_config
    from repro_torch.core.blocks import DiffusionBlocksModel
    cfg = get_config(W_ARCH)
    cut = {k: v for k, v in (("n_layers", n_layers),
                             ("n_encoder_layers", n_encoder_layers))
           if v is not None}
    cfg = dataclasses.replace(cfg, **cut)
    dbm = DiffusionBlocksModel(cfg, dataclasses.replace(
        DEFAULT_DB, num_blocks=blocks or DEFAULT_DB.num_blocks, **db))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = dbm.init(gen)
    for k in ("w", "b"):
        params["layers"]["adaln"][k].normal_(0.0, 0.02, generator=gen)
    return dbm, params, gen


def w_audio(rs, frames: int, d: int):
    """(frames, d) fp32 frame embeddings from the numpy generator ``rs``."""
    return rs.randn(frames, d).astype("float32")


def w_encodes(dbm):
    """Count and time (CUDA events) the model's ``encode_conditioning``
    calls, the encoder's run at each admission: returns the list of
    (start, end) events; ``del dbm.model.encode_conditioning`` restores the
    method."""
    m = dbm.model
    plain, events = m.encode_conditioning, []

    def encode(*a, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = plain(*a, **kw)
        end.record()
        events.append((start, end))
        return out
    m.encode_conditioning = encode
    return events


def w_serve_counts(dbm, ledger, encodes: int) -> dict:
    """The batchers' launches (``srv_counts``) and the encoder's: one
    ``full`` attention forward per encoder layer and admission."""
    counts = srv_counts(ledger)
    counts[ATTN[0]] += dbm.cfg.n_encoder_layers * encodes
    return counts


def w_bounds(dbm, params, mean_len: float, frames: int) -> dict:
    """Least device time of a decode step of 8 slots from its shapes (as
    ``vlm_bounds``): the 4 probes read every decoder layer's weights in
    fp32 (each block its own) plus the σ-MLP each, the readout the fp32
    head, the commit the bf16 copy of the attention, cross-attention and
    MLP weights; the probes and the commit each read the slots' committed
    K/V and their audio blocks (bf16, ``frames`` a slot) once."""
    cfg, B = dbm.cfg, CB_SLOTS
    L = cfg.n_layers
    layers = sum(t.numel() for _, t in _leaves(params["layers"]))
    commit = sum(t.numel() for p, t in _leaves(params["layers"])
                 if p[0] in ("attn", "xattn", "mlp"))
    head = params["head"]["w"].numel()
    cond = sum(t.numel() for _, t in _leaves(params["cond"]))
    kv_row = 2 * cfg.n_kv_heads * cfg.head_dim * 2
    hd_flops = cfg.n_heads * cfg.head_dim * 4
    nbytes = (layers * 4 + dbm.num_blocks * cond * 4 + head * 4 + commit * 2
              + 2 * L * B * (mean_len + frames) * kv_row)
    flops = 2 * B * (layers + head + commit) + 2 * L * B * (
        mean_len + frames) * hd_flops
    ms, by = bound(nbytes, flops, PEAK_FP32)
    return {"decode_step_ms": ms, "decode_step_by": by}


def w_static(dev, model) -> dict:
    """The static engine over BATCH requests, each with (1500, d) fp32
    audio, prompts of W_PROMPT tokens at most (ragged), MAX_NEW new tokens,
    bf16; then the same prompts and draws without audio: the tokens must
    differ."""
    import numpy as np
    from repro_torch import kernels as K
    from repro_torch.launch.serve import get_engine
    dbm, params, gen = model
    cfg = dbm.cfg
    A, _ = paged_layers(dbm)
    rs = np.random.RandomState(1)
    prompts = rs.randint(0, cfg.vocab_size, size=(BATCH, W_PROMPT))
    plens = rs.randint(W_PROMPT // 4, W_PROMPT + 1, size=BATCH)
    plens[-1] = W_PROMPT
    aux = {"audio_embs": np.stack([w_audio(rs, cfg.n_audio_frames,
                                           cfg.d_model)
                                   for _ in range(BATCH)])}
    eng = get_engine(dbm, precision="bf16", chunk_size=CHUNK)
    eng.generate(params, prompts, 2, prompt_lengths=plens, generator=gen,
                 aux_inputs=aux)
    eng.last_kv = None
    z, _ = eng.draw(MAX_NEW, BATCH, gen, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.generate(params, prompts, MAX_NEW, prompt_lengths=plens, z0=z,
                       aux_inputs=aux)
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    tim = eng.last_timing
    chunks = -(-W_PROMPT // CHUNK)
    expect = expected_counts(flash_decode=MAX_NEW * 2 * A,
                             flash_prefill=chunks * A,
                             flash_attention_fwd=cfg.n_encoder_layers)
    check_counts("whisper static", counts, expect)
    kv = eng.last_kv
    for name, t in (("self k", kv["self"].k), ("self v", kv["self"].v),
                    ("cross k", kv["cross"]["k"]),
                    ("cross v", kv["cross"]["v"])):
        if not torch.isfinite(t.float()).all():
            raise SmokeError(f"whisper static: non-finite {name}")
    eng.last_kv = kv = None
    K.reset_launch_counts()
    bare = eng.generate(params, prompts, MAX_NEW, prompt_lengths=plens,
                        z0=z)
    check_counts("whisper static, no audio", K.launch_counts(),
                 expected_counts(flash_decode=MAX_NEW * 2 * A,
                                 flash_prefill=chunks * A))
    add_counts(counts, K.launch_counts())
    eng.last_kv = None
    got, ref = _generated(out, plens), _generated(bare, plens)
    if not ((got >= 0) & (got < cfg.vocab_size)).all():
        raise SmokeError("whisper static: a token outside the vocabulary")
    differ = (got != ref).any(dim=1)
    decode_ms = tim["total_ms"] - tim["prefill_ms"]
    say(f"[whisper] static: bf16, greedy, {BATCH} requests each with "
        f"({cfg.n_audio_frames}, {cfg.d_model}) fp32 audio, prompts of "
        f"{plens.tolist()} tokens (chunk {CHUNK}), {MAX_NEW} new tokens: "
        f"wall {wall:.3f} s | {BATCH * MAX_NEW / wall:.1f} tok/s | ttft "
        f"{tim['ttft_ms']:.1f} ms (the encoder and the audio blocks' write, "
        f"and prefill: {tim['prefill_ms']:.1f} ms) | decode "
        f"{decode_ms / MAX_NEW:.2f} ms/step | peak {peak / 2**30:.2f} GiB | "
        f"launches {counts}")
    say(f"[whisper] static: the same prompts and draws without audio: "
        f"tokens differ in {int(differ.sum())} of {BATCH} requests")
    if not differ.any():
        raise SmokeError("whisper static: the audio did not change a token")
    return {"counts": counts, "wall_s": wall, "ttft_ms": tim["ttft_ms"],
            "decode_ms_per_step": decode_ms / MAX_NEW, "peak": peak}


def w_queue(vocab: int, d: int):
    """Phase 19's continuous traffic: CB_REQUESTS ``MarkovLM`` prompts from
    seed 1 of CB_MIN-W_CB_MAX tokens, the even ones opening with one shared
    CB_SHARED-token prefix and carrying one shared audio; the odd ones each
    their own; every audio W_FRAMES[0]-W_FRAMES[1] frames from seed 2.
    Returns [(prompt, {"audio_embs": (frames, d)})]."""
    import numpy as np
    from repro_torch.data import MarkovLM
    lm = MarkovLM(vocab_size=vocab, seed=7)
    rs, ra = np.random.RandomState(1), np.random.RandomState(2)
    frames = lambda: ra.randint(W_FRAMES[0], W_FRAMES[1] + 1)  # noqa: E731
    shared = lm.sample(rs, 1, CB_SHARED)[0]
    shared_audio = {"audio_embs": w_audio(ra, frames(), d)}
    out = []
    for i in range(CB_REQUESTS):
        if i % 2 == 0:
            n = rs.randint(CB_SHARED + 1, W_CB_MAX + 1)
            out.append((np.concatenate(
                [shared, lm.sample(rs, 1, n - CB_SHARED)[0]]), shared_audio))
        else:
            out.append((lm.sample(rs, 1, rs.randint(CB_MIN,
                                                    W_CB_MAX + 1))[0],
                        {"audio_embs": w_audio(ra, frames(), d)}))
    return out


def w_continuous(dev, model, queue) -> dict:
    """The graphed batcher over ``w_queue``: every request complete, no
    page or audio row left, launches equal to the dispatches' arithmetic
    and one encoder run per admission; tok/s, the segment step's ms
    against ``w_bounds``, the encoder's ms per admission, peak memory."""
    from repro_torch import kernels as K
    dbm, params, _ = model
    torch.cuda.reset_peak_memory_stats()
    cb = cb_batcher(dev, model, max_prompt=W_CB_MAX)
    t0 = time.perf_counter()
    cb.capture()
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    events = cb_timed(cb)
    enc = w_encodes(dbm)
    try:
        K.reset_launch_counts()
        t0 = time.perf_counter()
        for p, aux in queue:
            cb.submit(p, CB_NEW, aux_inputs=aux)
        done = cb.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        del dbm.model.encode_conditioning
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    cb_drained("whisper continuous", cb, done, CB_REQUESTS)
    if cb.cond_lengths.any():
        raise SmokeError(f"whisper continuous: audio rows left set "
                         f"{cb.cond_lengths.tolist()}")
    if len(enc) != CB_REQUESTS:
        raise SmokeError(f"whisper continuous: {len(enc)} encoder runs for "
                         f"{CB_REQUESTS} admissions")
    check_counts("whisper continuous", counts,
                 w_serve_counts(dbm, [(*paged_layers(dbm), cb.steps,
                                       cb.ingest_dispatches)], len(enc)))
    seg_ms = [a.elapsed_time(b) for a, b in events["segment"]]
    chunk_ms = [a.elapsed_time(b) for a, b in events["chunk"]]
    enc_ms = [a.elapsed_time(b) for a, b in enc]
    seg_step_ms = sum(seg_ms) / cb.steps
    in_dispatch = (sum(seg_ms) + sum(chunk_ms) + sum(enc_ms)) / (wall * 1e3)
    ttft = sorted(r.ttft for r in done)
    n_tok = sum(len(r.out) for r in done)
    frames = [r.aux_inputs["audio_embs"].shape[0] for r in done]
    mean_len = statistics.mean(len(r.prompt) for r in done) + CB_NEW / 2
    lb = w_bounds(dbm, params, mean_len, statistics.mean(frames))
    say(f"[whisper] continuous, {CB_REQUESTS} requests on {CB_SLOTS} slots, "
        f"bf16, prompts {CB_MIN}-{W_CB_MAX} tokens (the even ones behind a "
        f"{CB_SHARED}-token prefix with one shared audio), audio "
        f"{min(frames)}-{max(frames)} frames, each encoded alone at "
        f"admission, graphs captured in {capture_s:.2f} s: wall "
        f"{wall:.3f} s | {n_tok / wall:.1f} tok/s | TTFT median "
        f"{statistics.median(ttft) * 1e3:.1f} ms, max {ttft[-1] * 1e3:.1f} "
        f"ms | decode {seg_step_ms:.3f} ms per segment step "
        f"({len(seg_ms)} segments) against a bound of "
        f"{lb['decode_step_ms']:.3f} ms ({lb['decode_step_by']}) | chunk "
        f"dispatch {statistics.median(chunk_ms):.2f} ms median "
        f"({len(chunk_ms)}) | encoder {statistics.median(enc_ms):.2f} ms "
        f"median per admission (min {min(enc_ms):.2f}, max "
        f"{max(enc_ms):.2f}; {len(enc_ms)} runs, fp32, CUDA events) | "
        f"inside a dispatch or an encode {100 * in_dispatch:.1f}% of the "
        f"wall | prefix hits {cb.prefix.hits}, shared tokens "
        f"{sum(r.shared_tokens for r in done)} | peak {peak / 2**30:.2f} "
        f"GiB | launches {counts} | nvidia-smi (sm MHz, W, limit, C): "
        f"{gpu_query('clocks.sm,power.draw,power.limit,temperature.gpu')}")
    return {"counts": counts, "wall_s": wall, "tok_s": n_tok / wall,
            "segment_step_ms": seg_step_ms, "bound": lb,
            "chunk_ms_median": statistics.median(chunk_ms),
            "encoder_ms_median": statistics.median(enc_ms),
            "encoder_ms": [min(enc_ms), max(enc_ms)],
            "in_dispatch": in_dispatch, "peak_bytes": peak,
            "ttft_median_s": statistics.median(ttft),
            "capture_s": capture_s}


def w_migration(dev, model, queue) -> dict:
    """One audio request through a one-slot ``pages`` router (1 prefill + 1
    decode worker on one shared pool) and through a one-slot graphed
    batcher under the same generator seed: the tokens after the handoff
    equal the unmigrated run's, bit for bit."""
    from repro_torch import kernels as K
    dbm = model[0]
    p, aux = queue[1]
    reqs = [(p, VLM_MIGRATE_NEW, aux)]
    enc = w_encodes(dbm)
    try:
        K.reset_launch_counts()
        cb = cb_batcher(dev, model, seed=5, num_slots=1)
        cb.capture()
        cb.submit(p, VLM_MIGRATE_NEW, aux_inputs=aux)
        direct = [cb.run()[0].out]
        ledger = [srv_ledger(cb)]
        del cb
        router = dg_router(model, "pages", num_slots=1, n_decode=1)
        router.decode_workers[0].cb.generator.manual_seed(5)
        routed = dg_sequential(router, reqs)
        whole = dg_whole("whisper migration", router)
        ledger += [srv_ledger(w.cb) for w in router.workers]
        migrations = router.migrations
        del router
        counts = K.launch_counts()
    finally:
        del dbm.model.encode_conditioning
    check_counts("whisper migration", counts,
                 w_serve_counts(dbm, ledger, len(enc)))
    say(f"[whisper] migration: an audio request "
        f"({aux['audio_embs'].shape[0]} frames) through a pages router (1 "
        f"prefill + 1 decode worker, one slot each, one shared pool) "
        f"{'equals' if routed == direct else 'DIFFERS FROM'} a graphed "
        f"batcher's run under the same draws, bit for bit "
        f"({sum(map(len, direct))} tokens, {migrations} migrations, "
        f"{len(enc)} encoder runs: the block travels with the slot) | pool "
        f"{whole}")
    if routed != direct or migrations < 1 or len(enc) != 2:
        raise SmokeError(f"whisper migration: routed {routed}, direct "
                         f"{direct}, {len(enc)} encoder runs")
    return {"counts": counts}


def w_fp32_check(dev, model, queue) -> dict:
    """Greedy decoding of 8 audio requests under the fp32 policy for one
    segment, through the kernels and through ``impl="ref"`` (the encoder
    too): tokens identical, logits within 1e-3 relative."""
    import numpy as np
    from repro_torch import kernels as K
    few = [p for p, _ in queue[:CB_SLOTS]]
    auxes = [a for _, a in queue[:CB_SLOTS]]
    dbm = model[0]
    enc = w_encodes(dbm)
    try:
        K.reset_launch_counts()
        ck, lk, ek = cb_logged(dev, model, few, "fp32", "kernels", n_seg=1,
                               auxes=auxes)
        counts = K.launch_counts()
        runs = len(enc)
        _, lr, er = cb_logged(dev, model, few, "fp32", "ref", n_seg=1,
                              auxes=auxes)
    finally:
        del dbm.model.encode_conditioning
    check_counts("whisper fp32", counts,
                 w_serve_counts(dbm, [(*paged_layers(dbm), ck.steps,
                                       ck.ingest_dispatches)], runs))
    on = ek[0] >= 0
    rel = max(((lk[t] - lr[t])[on[:, t]].abs().max()
               / lr[t][on[:, t]].abs().max()).item()
              for t in range(CB_SEG) if on[:, t].any())
    equal = bool(np.array_equal(ek, er))
    say(f"[whisper] fp32 greedy at full width and depth, {CB_SLOTS} audio "
        f"requests, one segment, kernels (the encoder through the 3xTF32 "
        f"attention) vs plain versions: tokens "
        f"{'identical' if equal else 'DIFFER'} ({int(on.sum())}) | logits "
        f"rel max|diff| {rel:.2e} (limit 1e-3)")
    if not (rel <= 1e-3 and math.isfinite(rel)) or not equal:
        raise SmokeError(f"whisper fp32 check: logits {rel:.2e}, tokens "
                         f"identical {equal}")
    return {"counts": counts, "logits_rel": rel}


def phase_whisper(dev) -> dict:
    """Phase 19: whisper-small at full width and depth (12 encoder and 12
    decoder layers, d 768, 12 heads of 64, d_ff 3072, vocab 51865, 1500
    audio frames; LayerNorm, gelu, sinusoidal positions), after phase 18
    under its memory check; ``DEFAULT_DB`` (4 blocks of 3 decoder layers),
    random fp32 weights from seed 0, the AdaLN heads randomised. Served
    (bf16): ``w_static``, ``w_continuous``, ``w_migration``; the fp32
    greedy check ``w_fp32_check``; with serving's memory checked, trained
    (bf16 policy, bf16 audio, MarkovLM batches of TRAIN_BATCH x W_TRAIN_SEQ
    with TRAIN_BATCH x 1500 frames): ``resident_db_steps`` (concat x CE,
    all four AdamW states resident), one two_pass x l2 DB step of block 0,
    ``e2e_steps``; then the fp32 check of a 2 + 2-layer model, concat and
    two_pass, against ``impl="ref"``."""
    import numpy as np
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import MarkovLM
    from repro_torch.launch.serve import ContinuousBatcher
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    clear_cublas_workspaces()
    base = torch.cuda.memory_allocated()
    say(f"[whisper] memory allocated at the phase's start: "
        f"{base / 2**30:.3f} GiB")
    if base > W_MEM_START:
        raise SmokeError(f"whisper: {base / 2**30:.2f} GiB still allocated "
                         "from earlier phases")
    t0 = time.perf_counter()
    model = w_model(dev)
    dbm, params, gen = model
    torch.cuda.synchronize()
    cfg = dbm.cfg
    masters = sum(p.numel() * p.element_size() for _, p in _leaves(params))
    say(f"[whisper] {cfg.name}: {cfg.n_encoder_layers} encoder + "
        f"{cfg.n_layers} decoder layers d={cfg.d_model} heads={cfg.n_heads}"
        f" of {cfg.head_dim} ff={cfg.d_ff} vocab={cfg.vocab_size}, "
        f"{cfg.n_audio_frames} audio frames, {dbm.num_blocks} blocks "
        f"{dbm.ranges}; {sum(p.numel() for _, p in _leaves(params)) / 1e9:.3f}"
        f" B params fp32 made in {time.perf_counter() - t0:.1f} s")
    counts = {}
    static = w_static(dev, model)
    add_counts(counts, static["counts"])
    queue = w_queue(cfg.vocab_size, cfg.d_model)
    cont = w_continuous(dev, model, queue)
    add_counts(counts, cont["counts"])
    mig = w_migration(dev, model, queue)
    add_counts(counts, mig["counts"])
    fp32 = w_fp32_check(dev, model, queue)
    add_counts(counts, fp32["counts"])
    dbm.__dict__.pop("_compute_copies", None)     # serving's bf16 copy
    dbm.model.__dict__.pop("_unit_memo", None)
    dbm.__dict__.pop("_serve_engines", None)      # the static engine's pool
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() - base - masters
    stray = sum(isinstance(o, ContinuousBatcher) for o in gc.get_objects())
    say(f"[whisper] after serving: {left / 2**30:.3f} GiB allocated beyond "
        f"the {masters / 2**30:.2f} GiB of masters, {stray} batchers in "
        "memory")
    if left > 2**30 or stray:
        raise SmokeError(f"whisper serving left {left / 2**30:.2f} GiB "
                         f"beyond the masters and {stray} batchers")

    tcfg = TrainConfig(steps=100, warmup_steps=10, lr=1e-4)
    data = MarkovLM(vocab_size=cfg.vocab_size, seed=7).iterator(
        TRAIN_BATCH, W_TRAIN_SEQ)

    def audio():
        return {"audio_embs": torch.randn(
            TRAIN_BATCH, cfg.n_audio_frames, cfg.d_model, generator=gen,
            device=dev).to(torch.bfloat16)}
    torch.cuda.reset_peak_memory_stats()
    db = resident_db_steps(dbm, params, gen, tcfg, data, "whisper-train",
                           aux=audio)
    torch.cuda.empty_cache()
    db_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    two_pass = two_pass_step(two_pass_view(model), tcfg, data,
                             "whisper-train", aux=audio)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    e2e = e2e_steps(dbm, params, tcfg, data, "whisper-train", aux=audio)
    e2e_peak = torch.cuda.max_memory_allocated()
    for c in (db["launches"], two_pass["launches"], e2e["launches"]):
        add_counts(counts, c)
    say(f"[whisper-train] peak memory: DB steps with all {dbm.num_blocks} "
        f"AdamW states {db_peak / 2**30:.2f} GiB, two_pass step "
        f"{two_pass['peak_bytes'] / 2**30:.2f} GiB, e2e step "
        f"{e2e_peak / 2**30:.2f} GiB; nvidia-smi (sm MHz, W, limit, C): "
        f"{gpu_query('clocks.sm,power.draw,power.limit,temperature.gpu')}")
    del model, dbm, params, gen
    torch.cuda.empty_cache()
    check = w_model(dev, n_layers=W_CHECK_LAYERS,
                    n_encoder_layers=W_CHECK_LAYERS, blocks=1)
    grads = [("attn", "wq"), ("xattn", "wk"), ("xattn", "wq"),
             ("adaln", "w")]
    whole = [("encoder", "attn", "wq"), ("encoder", "mlp", "wi")]
    rs = np.random.RandomState(3)
    aux = {"audio_embs": torch.from_numpy(np.stack(
        [w_audio(rs, check[0].cfg.n_audio_frames, check[0].cfg.d_model)
         for _ in range(TRAIN_BATCH)])).to(dev)}
    kw = dict(whole=whole, batch=TRAIN_BATCH, seq=W_TRAIN_SEQ, aux=aux)
    cross = {"concat": db_crosscheck(dev, check, "whisper concat ce", grads,
                                     **kw),
             "two_pass": db_crosscheck(dev, two_pass_view(check),
                                       "whisper two-pass l2", grads, **kw)}
    del check, aux
    torch.cuda.empty_cache()
    clear_cublas_workspaces()
    left = torch.cuda.memory_allocated()
    say(f"[whisper] with everything dropped (no gc pass): "
        f"{left / 2**30:.3f} GiB allocated against {base / 2**30:.3f} GiB "
        "at the start")
    if left - base > 2**30:
        raise SmokeError(f"whisper: {(left - base) / 2**30:.2f} GiB left "
                         "allocated after the phase")
    took = time.perf_counter() - t_phase
    say(f"[whisper] phase 19 took {took:.1f} s | launches {counts}")
    return {"counts": counts, "static": static, "continuous": cont,
            "db": db, "two_pass": two_pass, "e2e": e2e, "db_peak": db_peak,
            "e2e_peak": e2e_peak, "crosscheck": cross, "seconds": took}


# ---------------------------------------------------------------------------
# 20. llama-3.2-vision-11b's training at full width
# ---------------------------------------------------------------------------

def train_bytes(n_params: float, block_params, units_params: float) -> dict:
    """The reckoning of a training phase before anything is made: fp32
    masters, the AdamW moments (two fp32 tensors a param) of every block's
    view (``block_params``: its units and the periphery), one block's fp32
    gradients and the bf16 copy of the units, in bytes."""
    largest = max(block_params)
    return {"masters": 4 * n_params,
            "adamw": sum(8 * p for p in block_params),
            "grads": 4 * largest, "bf16_copy": 2 * units_params}


def say_bytes(tag: str, what: str, b: dict) -> None:
    say(f"[{tag}] reckoning ({what}): fp32 masters {b['masters'] / 1e9:.2f}"
        f" GB + AdamW moments {b['adamw'] / 1e9:.2f} GB + one block's "
        f"gradients {b['grads'] / 1e9:.2f} GB + bf16 copy "
        f"{b['bf16_copy'] / 1e9:.2f} GB = {sum(b.values()) / 1e9:.2f} GB "
        "before any activation")


def spec_params(dbm) -> dict:
    """Params by top-level key of the model's spec, none allocated."""
    import numpy as np
    from repro_torch.nn.init import tree_items
    out = {}
    for path, spec in tree_items(dbm.model.spec):
        out[path[0]] = out.get(path[0], 0) + int(np.prod(spec.shape))
    return out


def phase_start(tag: str) -> int:
    """gc, the cache emptied and the bytes still allocated, which must be
    at most 1 GiB."""
    gc.collect()
    torch.cuda.empty_cache()
    clear_cublas_workspaces()
    base = torch.cuda.memory_allocated()
    say(f"[{tag}] memory allocated at the phase's start: "
        f"{base / 2**30:.3f} GiB")
    if base > PHASE_MEM_START:
        raise SmokeError(f"{tag}: {base / 2**30:.2f} GiB still allocated "
                         "from earlier phases")
    return base


def phase_end(tag: str, base: int) -> None:
    torch.cuda.empty_cache()
    clear_cublas_workspaces()
    left = torch.cuda.memory_allocated()
    say(f"[{tag}] with everything dropped (no gc pass): {left / 2**30:.3f} "
        f"GiB allocated against {base / 2**30:.3f} GiB at the start")
    if left - base > 2**30:
        raise SmokeError(f"{tag}: {(left - base) / 2**30:.2f} GiB left "
                         "allocated after the phase")


def phase_vlm_train(dev) -> dict:
    """Phase 20: llama-3.2-vision-11b trained at full width (d 4096, 32
    query heads on 8 KV heads of 128, d_ff 14336, 1601 image tokens), cut
    to VLM_TRAIN_LAYERS layers (one superblock of 4 self layers and the
    cross layer) in one block, the cross gates opened, the bf16 policy,
    ``MarkovLM`` batches of VLM_TRAIN_BATCH x TRAIN_SEQ over as many bf16
    image blocks from the seeded generator (so the cross layer's q, k and v
    are bf16 and the bf16 kernels run): ``resident_db_steps`` (concat x
    CE), one two_pass x l2 DB step, ``e2e_steps``; then, the model dropped,
    one self and one cross layer (``cross_attn_every`` 2) at full width,
    fp32: a DB step in concat x CE and in two_pass x l2 through the kernels
    against ``impl="ref"`` within 1e-3, the cross layer's ``wk``, ``wv``
    and ``xgate`` among the moments compared; memory back within 1 GiB."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import MarkovLM
    tag = "vlm-train"
    t_phase = time.perf_counter()
    base = phase_start(tag)
    dbm = vlm_model(dev, n_layers=VLM_TRAIN_LAYERS, blocks=1,
                    spec_only=True)
    n = spec_params(dbm)
    periphery = sum(v for k, v in n.items() if k != "units")
    b1 = train_bytes(sum(n.values()), [sum(n.values())], n["units"])
    say_bytes(tag, f"{VLM_TRAIN_LAYERS} layers, 1 block, "
              f"{sum(n.values()) / 1e9:.3f} B params", b1)
    two = 2 * VLM_TRAIN_LAYERS
    n2 = spec_params(vlm_model(dev, n_layers=two, blocks=2,
                               spec_only=True))
    half = n2["units"] / 2 + periphery
    say_bytes(tag, f"the cut not taken: {two} layers in 2 blocks, "
              f"{sum(n2.values()) / 1e9:.3f} B params",
              train_bytes(sum(n2.values()), [half, half], n2["units"]))
    t0 = time.perf_counter()
    model = vlm_model(dev, n_layers=VLM_TRAIN_LAYERS, blocks=1)
    dbm, params, gen = model
    torch.cuda.synchronize()
    cfg = dbm.cfg
    say(f"[{tag}] {cfg.name} cut to {cfg.n_layers} layers ("
        f"{dbm.model.n_units} superblock of {dbm.model.k_self} self + 1 "
        f"cross), d={cfg.d_model}, {cfg.n_heads} heads on {cfg.n_kv_heads} "
        f"KV heads of {cfg.head_dim}, {cfg.n_image_tokens} image tokens, "
        f"{dbm.num_blocks} block {dbm.ranges}; "
        f"{sum(p.numel() for _, p in _leaves(params)) / 1e9:.3f} B params "
        f"fp32 made in {time.perf_counter() - t0:.1f} s")
    tcfg = TrainConfig(steps=100, warmup_steps=10, lr=1e-4)
    data = MarkovLM(vocab_size=cfg.vocab_size, seed=7).iterator(
        VLM_TRAIN_BATCH, TRAIN_SEQ)

    def images():
        return {"image_embs": torch.randn(
            VLM_TRAIN_BATCH, cfg.n_image_tokens, cfg.d_model, generator=gen,
            device=dev).to(torch.bfloat16)}
    torch.cuda.reset_peak_memory_stats()
    db = resident_db_steps(dbm, params, gen, tcfg, data, tag, aux=images)
    torch.cuda.empty_cache()
    db_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    two_pass = two_pass_step(two_pass_view(model), tcfg, data, tag,
                             aux=images)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    e2e = e2e_steps(dbm, params, tcfg, data, tag, aux=images)
    e2e_peak = torch.cuda.max_memory_allocated()
    counts = {}
    for c in (db["launches"], two_pass["launches"], e2e["launches"]):
        add_counts(counts, c)
    say(f"[{tag}] peak memory: DB steps {db_peak / 2**30:.2f} GiB, two_pass "
        f"step {two_pass['peak_bytes'] / 2**30:.2f} GiB, e2e step "
        f"{e2e_peak / 2**30:.2f} GiB of "
        f"{torch.cuda.get_device_properties(dev).total_memory / 2**30:.1f} "
        f"(reckoned {sum(b1.values()) / 2**30:.2f} GiB before activations); "
        f"nvidia-smi (sm MHz, W, limit, C): "
        f"{gpu_query('clocks.sm,power.draw,power.limit,temperature.gpu')}")
    del model, dbm, params, gen
    torch.cuda.empty_cache()
    check = vlm_model(dev, n_layers=2, blocks=1, cross_every=2)
    grads = [("self", "attn", "wq"), ("self", "mlp", "wg"),
             ("cross", "attn", "wq"), ("cross", "attn", "wk"),
             ("cross", "attn", "wv"), ("cross", "xgate"),
             ("cross", "adaln", "w")]
    cgen = torch.Generator(device=dev).manual_seed(4)
    aux = {"image_embs": torch.randn(
        VLM_TRAIN_BATCH, check[0].cfg.n_image_tokens, check[0].cfg.d_model,
        generator=cgen, device=dev)}
    kw = dict(stack="units", batch=VLM_TRAIN_BATCH, aux=aux)
    cross = {"concat": db_crosscheck(dev, check, "vlm concat ce", grads,
                                     **kw),
             "two_pass": db_crosscheck(dev, two_pass_view(check),
                                       "vlm two-pass l2", grads, **kw)}
    del check, aux
    phase_end(tag, base)
    took = time.perf_counter() - t_phase
    say(f"[{tag}] phase 20 took {took:.1f} s | launches {counts}")
    return {"counts": counts, "db": db, "two_pass": two_pass, "e2e": e2e,
            "db_peak": db_peak, "e2e_peak": e2e_peak, "crosscheck": cross,
            "reckoned_bytes": b1, "seconds": took}


# ---------------------------------------------------------------------------
# 21. phi3.5-moe-42b-a6.6b served and trained at full width
# ---------------------------------------------------------------------------

def moe_model(dev, n_layers, blocks=None, spec_only=False):
    """phi3.5-moe-42b-a6.6b cut to ``n_layers`` layers in DEFAULT_DB's
    blocks (or ``blocks``), random fp32 weights from seed 0, the AdaLN
    heads randomised. Returns (dbm, params, gen), or the dbm alone with
    ``spec_only`` (nothing allocated)."""
    from repro_torch.configs import DEFAULT_DB, get_config
    from repro_torch.core.blocks import DiffusionBlocksModel
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=n_layers)
    dbm = DiffusionBlocksModel(cfg, dataclasses.replace(
        DEFAULT_DB, num_blocks=blocks or DEFAULT_DB.num_blocks))
    if spec_only:
        return dbm
    gen = torch.Generator(device=dev).manual_seed(0)
    params = dbm.init(gen)
    for k in ("w", "b"):
        params["layers"]["adaln"][k].normal_(0.0, 0.02, generator=gen)
    return dbm, params, gen


def moe_static(dev, model) -> dict:
    """The static engine, bf16, greedy: BATCH requests with prompts padded
    to PROMPT (ragged), chunk CHUNK, MAX_NEW new tokens, after a 2-token
    warm-up; launches equal to the path's arithmetic, tokens in the
    vocabulary, pages finite."""
    from repro_torch import kernels as K
    from repro_torch.launch.serve import get_engine
    dbm, params, gen = model
    prompts, plens = prompts_np(dbm.cfg.vocab_size)
    eng = get_engine(dbm, precision="bf16", chunk_size=CHUNK)
    eng.generate(params, prompts, 2, prompt_lengths=plens, generator=gen)
    eng.last_kv = None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.generate(params, prompts, MAX_NEW, prompt_lengths=plens,
                       generator=gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    tim = eng.last_timing
    L = dbm.cfg.n_layers
    check_counts("moe static", counts, expected_counts(
        flash_decode=MAX_NEW * 2 * L, gate_residual=MAX_NEW * 2 * L,
        flash_prefill=-(-PROMPT // CHUNK) * L))
    gen_tok = _generated(out, plens)
    if not ((gen_tok >= 0) & (gen_tok < dbm.cfg.vocab_size)).all():
        raise SmokeError("moe: generated token outside the vocabulary")
    for name in ("k", "v"):
        if not torch.isfinite(getattr(eng.last_kv, name)[:, 1:].float()
                              ).all():
            raise SmokeError(f"moe: non-finite {name} pages after serving")
    decode_ms = (tim["total_ms"] - tim["prefill_ms"]) / MAX_NEW
    say(f"[moe] static engine, bf16, greedy, {BATCH} requests (prompts "
        f"{plens.tolist()}), chunk {CHUNK}, {MAX_NEW} new: wall {wall:.3f} s"
        f" | {BATCH * MAX_NEW / wall:.1f} tok/s | prefill "
        f"{tim['prefill_ms']:.1f} ms | decode {decode_ms:.2f} ms/step | "
        f"peak {peak / 2**30:.2f} GiB | launches {counts} | nvidia-smi (sm "
        f"MHz, W, limit, C): "
        f"{gpu_query('clocks.sm,power.draw,power.limit,temperature.gpu')}")
    eng.last_kv = None
    dbm.__dict__.pop("_serve_engines", None)
    return {"counts": counts, "wall_s": wall, "decode_ms_per_step": decode_ms,
            "prefill_ms": tim["prefill_ms"], "peak_bytes": peak}


def moe_fp32_check(dev) -> dict:
    """MOE_CHECK_SERVE_LAYERS layers at full width in 2 blocks, fp32: 8
    requests of phase 5b's queue for one segment through the kernels and
    through ``impl="ref"``; the greedy tokens identical and the logits
    within 1e-3 relative."""
    import numpy as np
    from repro_torch import kernels as K
    model = moe_model(dev, MOE_CHECK_SERVE_LAYERS, blocks=2)
    prompts, _ = cb_queue(model[0].cfg.vocab_size)
    few = prompts[:CB_SLOTS]
    K.reset_launch_counts()
    ck, lk, ek = cb_logged(dev, model, few, "fp32", "kernels", n_seg=1)
    counts = K.launch_counts()
    check_counts("moe fp32", counts, cb_counts(model[0], ck))
    _, lr, er = cb_logged(dev, model, few, "fp32", "ref", n_seg=1)
    on = ek[0] >= 0
    rel = max(((lk[t] - lr[t])[on[:, t]].abs().max()
               / lr[t][on[:, t]].abs().max()).item()
              for t in range(CB_SEG) if on[:, t].any())
    equal = bool(np.array_equal(ek, er))
    say(f"[moe] fp32 depth cut ({MOE_CHECK_SERVE_LAYERS} layers, 2 blocks, "
        f"full width), {CB_SLOTS} requests, one segment, kernels vs plain "
        f"versions: logits rel max|diff| {rel:.2e} (limit 1e-3) | greedy "
        f"tokens {'equal' if equal else 'DIFFER'} ({int(on.sum())})")
    if not (rel <= 1e-3 and math.isfinite(rel)) or not equal:
        raise SmokeError(f"moe fp32 cross-check: logits {rel:.2e}, tokens "
                         f"equal {equal}")
    return {"counts": counts, "logits_rel": rel}


def moe_capacity(moe, g: int) -> int:
    """The slots an expert has in a group of ``g`` tokens (``nn.moe``)."""
    return max(int(moe.capacity_factor * moe.top_k * g / moe.num_experts), 1)


@torch.no_grad()
def moe_drop_share(dbm, params, tokens, gen) -> float:
    """The share of the routers' (token, expert) picks past capacity in
    one bf16 ``block_loss`` forward of each block over ``tokens``: every
    MoE layer's routing counted through ``nn.moe.route``."""
    from repro_torch.nn import moe as M
    plain, stats = M.moe_fwd, [0, 0]

    def counted(p, x, cfg, kind, group_size=None):
        _, gates, _, pos, cap = M.route(p, x, cfg, group_size)
        sel = gates > 0
        stats[0] += int((sel & (pos >= cap)).sum())
        stats[1] += int(sel.sum())
        return plain(p, x, cfg, kind, group_size)
    M.moe_fwd = counted
    try:
        for b in range(dbm.num_blocks):
            dbm.block_loss(params, b, tokens, gen, precision="bf16")
    finally:
        M.moe_fwd = plain
    return stats[0] / stats[1]


def phase_moe(dev) -> dict:
    """Phase 21: phi3.5-moe-42b-a6.6b at full width (d 4096, 32 query heads
    on 8 KV heads of 128, LayerNorm, swiglu experts: 16 of d_ff 6400, top
    2, capacity factor 1.25), random fp32 weights from seed 0, the AdaLN
    heads randomised, bf16 policy. Served cut to MOE_SERVE_LAYERS layers in
    DEFAULT_DB's 4 blocks: ``moe_static``, phase 5b's queue through the
    graphed batcher (``queue_serve``), ``moe_fp32_check``; serving must
    leave at most 1 GiB beyond the masters. Trained cut to MOE_TRAIN_LAYERS
    layers in as many blocks, ``MarkovLM`` batches of VLM_TRAIN_BATCH x
    TRAIN_SEQ: ``resident_db_steps`` (concat x CE, both AdamW states
    resident), one two_pass x l2 DB step, ``e2e_steps``, each printing the
    router aux loss, and the share of picks dropped for capacity; then
    MOE_CHECK_LAYERS layer at full width, fp32: a DB step in concat x CE
    and in two_pass x l2 through the kernels against ``impl="ref"`` within
    1e-3, the router's and the experts' moments among those compared;
    memory back within 1 GiB."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import MarkovLM
    from repro_torch.nn import moe as M
    t_phase = time.perf_counter()
    base = phase_start("moe")
    n = spec_params(moe_model(dev, MOE_SERVE_LAYERS, spec_only=True))
    total = sum(n.values())
    say(f"[moe] reckoning (serving, {MOE_SERVE_LAYERS} layers, "
        f"{total / 1e9:.3f} B params): fp32 masters {4 * total / 1e9:.2f} GB"
        f" + bf16 copy of the layers {2 * n['layers'] / 1e9:.2f} GB = "
        f"{(4 * total + 2 * n['layers']) / 2**30:.2f} GiB; a decode step "
        f"reads each layer's {n['layers'] / MOE_SERVE_LAYERS / 1e9:.3f} B "
        "params once in the fp32 probe and once in the bf16 commit: "
        f"{6 * n['layers'] / 1e9:.1f} GB, "
        f"{6 * n['layers'] / HBM_BYTES_PER_S * 1e3:.1f} ms at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s")
    t0 = time.perf_counter()
    model = moe_model(dev, MOE_SERVE_LAYERS)
    dbm, params, _ = model
    torch.cuda.synchronize()
    cfg, moe = dbm.cfg, dbm.cfg.moe
    masters = sum(p.numel() * p.element_size() for _, p in _leaves(params))
    say(f"[moe] {cfg.name} cut to {cfg.n_layers} layers, d={cfg.d_model}, "
        f"{cfg.n_heads} heads on {cfg.n_kv_heads} KV heads of "
        f"{cfg.head_dim}, {moe.num_experts} experts of d_ff {cfg.d_ff}, top "
        f"{moe.top_k}, capacity factor {moe.capacity_factor}, vocab "
        f"{cfg.vocab_size}, {dbm.num_blocks} blocks {dbm.ranges}; "
        f"{masters / 4e9:.3f} B params fp32 made in "
        f"{time.perf_counter() - t0:.1f} s; decode routes {CB_SLOTS} slot "
        f"tokens a group: capacity max(int({moe.capacity_factor} x "
        f"{moe.top_k} x {CB_SLOTS} / {moe.num_experts}), 1) = "
        f"{moe_capacity(moe, CB_SLOTS)} an expert")
    counts = {}
    static = moe_static(dev, model)
    add_counts(counts, static["counts"])
    serve = queue_serve(dev, model, "moe")
    add_counts(counts, serve["counts"])
    del model, dbm, params
    gc.collect()
    torch.cuda.empty_cache()
    fp32 = moe_fp32_check(dev)
    add_counts(counts, fp32["counts"])
    torch.cuda.empty_cache()

    tag = "moe-train"
    n = spec_params(moe_model(dev, MOE_TRAIN_LAYERS, MOE_TRAIN_LAYERS,
                              spec_only=True))
    periphery = sum(v for k, v in n.items() if k != "layers")
    per_block = n["layers"] / MOE_TRAIN_LAYERS + periphery
    b1 = train_bytes(sum(n.values()), [per_block] * MOE_TRAIN_LAYERS,
                     n["layers"])
    say_bytes(tag, f"{MOE_TRAIN_LAYERS} layers in {MOE_TRAIN_LAYERS} blocks"
              f", {sum(n.values()) / 1e9:.3f} B params, every block's AdamW "
              "state resident", b1)
    t0 = time.perf_counter()
    model = moe_model(dev, MOE_TRAIN_LAYERS, MOE_TRAIN_LAYERS)
    dbm, params, gen = model
    torch.cuda.synchronize()
    say(f"[{tag}] depth cut to {MOE_TRAIN_LAYERS} layers, {dbm.num_blocks} "
        f"blocks {dbm.ranges}: "
        f"{sum(p.numel() for _, p in _leaves(params)) / 1e9:.3f} B params "
        f"fp32 made in {time.perf_counter() - t0:.1f} s")
    tcfg = TrainConfig(steps=100, warmup_steps=10, lr=1e-4)
    lm = MarkovLM(vocab_size=cfg.vocab_size, seed=7)
    data = lm.iterator(VLM_TRAIN_BATCH, TRAIN_SEQ)
    torch.cuda.reset_peak_memory_stats()
    db = resident_db_steps(dbm, params, gen, tcfg, data, tag)
    torch.cuda.empty_cache()
    db_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    two_pass = two_pass_step(two_pass_view(model), tcfg, data, tag)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    e2e = e2e_steps(dbm, params, tcfg, data, tag)
    e2e_peak = torch.cuda.max_memory_allocated()
    for c in (db["launches"], two_pass["launches"], e2e["launches"]):
        add_counts(counts, c)
    drop = moe_drop_share(dbm, params,
                          torch.as_tensor(next(data), device=dev), gen)
    g = min(M.GROUP_SIZE, 2 * VLM_TRAIN_BATCH * TRAIN_SEQ)
    say(f"[{tag}] routing of one bf16 DB forward a block (the concat "
        f"stream, {2 * VLM_TRAIN_BATCH * TRAIN_SEQ} tokens in groups of "
        f"{g}, capacity {moe_capacity(moe, g)} an expert): "
        f"{100 * drop:.2f}% of the picks dropped for capacity")
    say(f"[{tag}] peak memory: DB steps with both AdamW states "
        f"{db_peak / 2**30:.2f} GiB, two_pass step "
        f"{two_pass['peak_bytes'] / 2**30:.2f} GiB, e2e step "
        f"{e2e_peak / 2**30:.2f} GiB of "
        f"{torch.cuda.get_device_properties(dev).total_memory / 2**30:.1f} "
        f"(reckoned {sum(b1.values()) / 2**30:.2f} GiB before activations); "
        f"nvidia-smi (sm MHz, W, limit, C): "
        f"{gpu_query('clocks.sm,power.draw,power.limit,temperature.gpu')}")
    del model, dbm, params, gen
    torch.cuda.empty_cache()
    check = moe_model(dev, MOE_CHECK_LAYERS, blocks=1)
    grads = [("attn", "wq"), ("moe", "router", "w"), ("moe", "wi"),
             ("moe", "wo"), ("adaln", "w")]
    kw = dict(batch=VLM_TRAIN_BATCH)
    cross = {"concat": db_crosscheck(dev, check, "moe concat ce", grads,
                                     **kw),
             "two_pass": db_crosscheck(dev, two_pass_view(check),
                                       "moe two-pass l2", grads, **kw)}
    del check
    phase_end("moe", base)
    took = time.perf_counter() - t_phase
    say(f"[moe] phase 21 took {took:.1f} s | launches {counts}")
    return {"counts": counts, "static": static, "serve": serve,
            "fp32_rel": fp32["logits_rel"], "db": db, "two_pass": two_pass,
            "e2e": e2e, "db_peak": db_peak, "e2e_peak": e2e_peak,
            "drop_share": drop, "crosscheck": cross, "seconds": took}


# ---------------------------------------------------------------------------
# 22. xlstm-125m served at full width and depth
# ---------------------------------------------------------------------------

def xl_model(dev):
    """xlstm-125m at full width and depth (12 layers: 6 units of one sLSTM
    and one mLSTM block, d 768, 4 heads) in XL_BLOCKS blocks, random fp32
    weights from seed 0, the AdaLN heads randomised. Returns (dbm, params,
    gen)."""
    from repro_torch.configs import DEFAULT_DB, get_config
    from repro_torch.core.blocks import DiffusionBlocksModel
    dbm = DiffusionBlocksModel(get_config(XL_ARCH), dataclasses.replace(
        DEFAULT_DB, num_blocks=XL_BLOCKS))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = dbm.init(gen)
    for kind in ("slstm", "mlstm"):
        for k in ("w", "b"):
            params["units"][kind]["adaln"][k].normal_(0.0, 0.02,
                                                      generator=gen)
    return dbm, params, gen


def xl_state_bytes(dbm) -> int:
    """Bytes of one slot's state (every unit's sLSTM and mLSTM leaves),
    from a meta cache: nothing allocated."""
    from repro_torch.nn import cache as KVC
    kv = dbm.model.init_paged_cache(1, 1, PSZ, device="meta")
    return sum(t.numel() * t.element_size() for t in KVC.cache_tensors(kv))


def xl_bounds(dbm, params) -> dict:
    """Least device time of a decode step and of a prefill chunk over BATCH
    slots from their shapes (larger of bytes over 3.35 TB/s and flops over
    the fp32 peak: the family computes in fp32). A step: the probes (every
    unit once across the blocks) read the units' fp32 weights with their
    AdaLN heads, the commit reads them again without, the head once and
    the σ-MLP once a block; the state rows are read by the probes and read
    and written by the commit. A chunk: the commit's weights once, CHUNK
    tokens a slot computed, the rows read and written."""
    units = params["units"]
    w_units = sum(t.numel() for _, t in _leaves(units))
    w_adaln = sum(t.numel() for k in units
                  for _, t in _leaves(units[k]["adaln"]))
    head = params["head"]["w"].numel()
    cond = sum(t.numel() for _, t in _leaves(params["cond"]))
    probe_w, commit_w = 4 * w_units, 4 * (w_units - w_adaln)
    rows = BATCH * xl_state_bytes(dbm)
    small = 4 * head + dbm.num_blocks * 4 * cond
    dec = bound(probe_w + commit_w + small + 3 * rows,
                2 * BATCH * (probe_w + commit_w + 4 * head) / 4, PEAK_FP32)
    pre = bound(commit_w + 2 * rows, 2 * (commit_w / 4) * BATCH * CHUNK,
                PEAK_FP32)
    return {"chunk_ms": pre[0], "chunk_by": pre[1],
            "decode_step_ms": dec[0], "decode_step_by": dec[1],
            "decode_bytes": {"probe weights": probe_w,
                             "commit weights": commit_w,
                             "state rows": 3 * rows,
                             "head and sigma-MLP": small}}


def xl_finite(tag: str, kv) -> None:
    from repro_torch.nn import cache as KVC
    for t in KVC.cache_tensors(kv):
        if not torch.isfinite(t).all():
            raise SmokeError(f"{tag}: non-finite state after serving")


def xl_static(dev, model) -> dict:
    """The static engine, bf16 policy (the family computes and keeps its
    state in fp32 under it), greedy: BATCH requests with prompts padded to
    PROMPT (ragged), chunk CHUNK, MAX_NEW new tokens, after a one-chunk
    warm-up; launches equal to the path's arithmetic (a gate-residual a
    block in the probes, none in the commit or the chunk), tokens in the
    vocabulary, the state finite; then 4 more decode steps under the
    profiler, for the device's busy share."""
    from repro_torch import kernels as K
    from repro_torch.launch.serve import get_engine
    from repro_torch.nn import cache as KVC
    dbm, params, gen = model
    cfg = dbm.cfg
    _, G = paged_layers(dbm)
    prompts, plens = prompts_np(cfg.vocab_size)
    eng = get_engine(dbm, precision="bf16", chunk_size=CHUNK)
    eng.generate(params, prompts[:, :CHUNK], 2, generator=gen)
    eng.last_kv = None
    z, _ = eng.draw(MAX_NEW, BATCH, gen, dev)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.generate(params, prompts, MAX_NEW, prompt_lengths=plens, z0=z)
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    tim = eng.last_timing
    n_chunks = -(-PROMPT // CHUNK)
    check_counts("xlstm static", counts,
                 expected_counts(gate_residual=MAX_NEW * G))
    kv = eng.last_kv
    eng.last_kv = None
    xl_finite("xlstm static", kv)
    got = _generated(out, plens)
    if not ((got >= 0) & (got < cfg.vocab_size)).all():
        raise SmokeError("xlstm static: token outside the vocabulary")
    # 4 more decode steps on the run's state, for the busy share
    lens = torch.as_tensor(plens + MAX_NEW, dtype=torch.int32, device=dev)
    table = KVC.identity_page_table(BATCH, 1, device=dev)
    K.reset_launch_counts()
    pwall, busy, top = device_busy(lambda: eng.decode(
        params, kv, table, lens, lens + 4, 4, generator=gen), top=8)
    more = K.launch_counts()
    check_counts("xlstm static, profiled", more,
                 expected_counts(gate_residual=4 * G))
    add_counts(counts, more)
    del kv
    decode_ms = (tim["total_ms"] - tim["prefill_ms"]) / MAX_NEW
    lb = xl_bounds(dbm, params)
    say(f"[xlstm] static: bf16 policy (fp32 compute and state), greedy, "
        f"{BATCH} requests, prompts padded to {PROMPT} (lengths "
        f"{plens.tolist()}), chunk {CHUNK}, {MAX_NEW} new tokens")
    say(f"[xlstm] static: wall {wall:.3f} s | {BATCH * MAX_NEW / wall:.1f} "
        f"tok/s | ttft {tim['ttft_ms']:.1f} ms (prefill "
        f"{tim['prefill_ms']:.1f} ms: {tim['prefill_ms'] / n_chunks:.1f} ms "
        f"a chunk, eager) | decode {decode_ms:.2f} ms/step | bound from the "
        f"shapes: chunk {lb['chunk_ms']:.3f} ms ({lb['chunk_by']}), decode "
        f"{lb['decode_step_ms']:.3f} ms/step ({lb['decode_step_by']}; "
        + ", ".join(f"{k} {v / 1e9:.3f} GB"
                    for k, v in lb["decode_bytes"].items()) + ")")
    say(f"[xlstm] static: 4 decode steps under the profiler: device busy "
        f"{busy:.1f} ms of {pwall:.1f} ms ({100 * busy / pwall:.1f}%)")
    for ms, count, key in top:
        say(f"[xlstm]   {ms:8.2f} ms  x{count:<6d} {key[:90]}")
    return {"counts": counts, "wall_s": wall, "ttft_ms": tim["ttft_ms"],
            "chunk_ms": tim["prefill_ms"] / n_chunks,
            "decode_ms_per_step": decode_ms, "busy": busy / pwall,
            "bounds": lb}


def xl_continuous(dev, model) -> tuple:
    """The graphed batcher on phase 5b's queue (CB_REQUESTS prompts of
    CB_MIN-CB_MAX tokens on CB_SLOTS slots, CB_NEW new each, draws keyed by
    prompt and position, ``hyb_z``, so a request's tokens do not depend on
    its slot or schedule; no prefix cache: refused for the family); then
    on the same batcher the first CB_SLOTS prompts again, each in a slot
    that other requests held before, one of them spilled mid-decode
    through the wire bytes and restored: all must finish with the first
    run's tokens. Returns (stats, the first run's tokens, launch
    ledger)."""
    from repro_torch import kernels as K
    from repro_torch.nn import cache as KVC
    dbm = model[0]
    prompts, _ = cb_queue(dbm.cfg.vocab_size)
    K.reset_launch_counts()
    cb = cb_batcher(dev, model, prefix_cache=False)
    cb.draw_segment = hyb_keyed_draws(cb)
    t0 = time.perf_counter()
    cb.capture()
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    events = cb_timed(cb)
    for p in prompts:
        cb.submit(p, CB_NEW)
    reqs = list(cb.queue)
    t0 = time.perf_counter()
    cb.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bad = [r.rid for r in reqs if len(r.out) != CB_NEW or r.error]
    if bad or cb.page_refs or len(cb.free_pages) != cb.total_pages - 1:
        raise SmokeError(f"xlstm continuous: short or failed {bad}, pages "
                         f"{len(cb.free_pages)} free of {cb.total_pages - 1}")
    first = [list(r.out) for r in reqs]
    seg_ms = [s.elapsed_time(e) for s, e in events["segment"]]
    chunk_ms = [s.elapsed_time(e) for s, e in events["chunk"]]
    in_dispatch = (sum(seg_ms) + sum(chunk_ms)) / (wall * 1e3)
    ttft = sorted(r.ttft for r in reqs)
    n_tok = sum(len(r.out) for r in reqs)
    state_mb = KVC.cache_bytes(cb.kv) / 1e6
    say(f"[xlstm] continuous: {CB_REQUESTS} requests of {CB_MIN}-{CB_MAX} "
        f"tokens on {CB_SLOTS} slots (phase 5b's queue), bf16 policy, "
        f"greedy, chunk {CHUNK} (a chain of per-token steps), seg_len "
        f"{CB_SEG}, {CB_NEW} new tokens each, no prefix cache; both "
        f"dispatches replayed from graphs captured in {capture_s:.2f} s "
        f"(warm-ups {cb.graph_warmups}); state {state_mb:.1f} MB fp32, no "
        "pages")
    say(f"[xlstm] continuous: wall {wall:.3f} s | {n_tok / wall:.1f} tok/s "
        f"| TTFT median {statistics.median(ttft) * 1e3:.1f} ms, max "
        f"{ttft[-1] * 1e3:.1f} ms | decode {sum(seg_ms) / cb.steps:.3f} ms "
        f"per segment step ({len(seg_ms)} segments) | chunk dispatch "
        f"{statistics.median(chunk_ms):.2f} ms median ({len(chunk_ms)}) | "
        f"inside a dispatch {100 * in_dispatch:.1f}% of the wall (CUDA "
        f"events) | nvidia-smi (sm MHz, W, limit, C): "
        f"{gpu_query('clocks.sm,power.draw,power.limit,temperature.gpu')}")
    stats = {"wall_s": wall, "tok_s": n_tok / wall,
             "ttft_median_s": statistics.median(ttft),
             "segment_step_ms": sum(seg_ms) / max(1, cb.steps),
             "chunk_ms_median": statistics.median(chunk_ms),
             "in_dispatch": in_dispatch, "capture_s": capture_s}
    del events, cb._decode_segment, cb._chunk     # cb_timed's wrappers

    # the first slots' prompts again, in recycled slots, one spilled
    for p in prompts[:CB_SLOTS]:
        cb.submit(p, CB_NEW)
    again = list(cb.queue)
    d0 = cb.decode_dispatches
    while cb.decode_dispatches < d0 + 2:
        cb.step()
    s = next((s for s in range(cb.num_slots) if cb.active[s]
              and cb.lengths[s] >= cb.plens[s]), None)
    if s is None:
        raise SmokeError("xlstm continuous: no slot decoding to preempt")
    with cb._pool_lock:
        req = cb._preempt_slot(s)
    raw = req.spilled.to_bytes()
    req.spilled = KVC.SpilledSlot.from_bytes(raw)
    n_leaves = len(req.spilled.data)
    cb.run()
    torch.cuda.synchronize()
    resumed = [list(r.out) for r in again]
    say(f"[xlstm] continuous: the first {CB_SLOTS} prompts again, each in "
        f"a slot other requests held before, request {req.rid} spilled "
        f"from slot {s} mid-decode ({len(raw) / 1e6:.1f} MB of wire bytes: "
        f"its state rows, {n_leaves} leaves) and restored: "
        f"tokens {'equal to' if resumed == first[:CB_SLOTS] else 'DIFFER FROM'}"
        f" the first run's (preemptions {cb.preemptions}, restores "
        f"{cb.restores})")
    if resumed != first[:CB_SLOTS] or cb.restores != 1:
        raise SmokeError("xlstm continuous: the recycled or restored runs' "
                         "tokens differ from the first run's")
    stats["http_start_s"], stats["http_wall_s"] = xl_http(cb, prompts,
                                                          first)
    ledger = [srv_ledger(cb)]
    check_counts("xlstm continuous", K.launch_counts(), srv_counts(ledger))
    return stats, ledger


def xl_slot_reuse(dev, model) -> tuple:
    """One slot, eager, chunks of XL_REUSE_LEN (one a prompt): [p1, p2] and
    [p1', p2] (p1' another prompt of p1's length), keyed draws; p2 must
    give the same tokens after either first occupant, and p1 and p1' other
    tokens. Returns (the launch ledger, p2's tokens)."""
    from repro_torch.launch.serve import ContinuousBatcher
    dbm, params, _ = model
    prompts = hyb_prompts(dbm.cfg.vocab_size, 3, XL_REUSE_LEN,
                          XL_REUSE_LEN, 3)
    outs, ledger = [], []
    for first in prompts[:2]:
        cb = ContinuousBatcher(
            dbm, params, num_slots=1, page_size=PSZ, max_prompt=XL_REUSE_LEN,
            max_len=XL_REUSE_LEN + XL_REUSE_NEW, seg_len=XL_REUSE_NEW,
            chunk_size=XL_REUSE_LEN, precision="bf16", graphs=False)
        cb.draw_segment = hyb_keyed_draws(cb)
        cb.submit(first, XL_REUSE_NEW)
        cb.submit(prompts[2], XL_REUSE_NEW)
        outs.append([list(r.out) for r in cb.run()])
        ledger.append(srv_ledger(cb))
        del cb
    same = outs[0][1] == outs[1][1]
    say(f"[xlstm] slot reuse: one slot, two first occupants of "
        f"{XL_REUSE_LEN} tokens, then the same second request: its "
        f"{XL_REUSE_NEW} tokens {'identical' if same else 'DIFFER'} (the "
        f"first occupants' {'differ' if outs[0][0] != outs[1][0] else 'ARE EQUAL'})")
    if not same or outs[0][0] == outs[1][0]:
        raise SmokeError("xlstm slot reuse: the first occupant leaked into "
                         "the second request")
    return ledger, outs[0][1]


def xl_http(cb, prompts, want) -> tuple:
    """The server over the graphed batcher ``cb`` (its graphs captured,
    keyed draws): the first XL_HTTP_REQUESTS prompts of the queue at once
    over HTTP/SSE; each must stream the tokens ``want`` holds (the
    batcher's first run). Returns (start s, wall s)."""
    import asyncio
    from repro_torch.launch.server import InferenceServer, stream_generate
    server = InferenceServer(cb)

    async def run():
        t0 = time.perf_counter()
        await server.start()
        start_s = time.perf_counter() - t0
        try:
            t0 = time.perf_counter()
            res = await asyncio.gather(*(
                stream_generate(SRV_HOST, server.port, p, CB_NEW)
                for p in prompts[:XL_HTTP_REQUESTS]))
            return res, start_s, time.perf_counter() - t0
        finally:
            await server.aclose()
    results, start_s, wall = asyncio.run(run())
    srv_runner("xlstm", server.runner, 0)
    srv_complete("xlstm http", [dict(r, max_new=CB_NEW) for r in results])
    ok = [r["ids"] for r in results] == want[:XL_HTTP_REQUESTS]
    ttft = statistics.median(r["token_times"][0] - r["submit_t"]
                             for r in results)
    say(f"[xlstm] server over the same batcher: {XL_HTTP_REQUESTS} requests"
        f" at once over HTTP/SSE (started in {start_s:.2f} s): wall "
        f"{wall:.3f} s, {XL_HTTP_REQUESTS * CB_NEW / wall:.1f} tok/s, TTFT "
        f"median {ttft * 1e3:.1f} ms (client clock) | tokens "
        f"{'equal to' if ok else 'DIFFER FROM'} the batcher's first run")
    if not ok:
        raise SmokeError("xlstm server: streamed tokens differ from the "
                         "batcher's")
    return start_s, wall


def xl_fp32_check(dev, model) -> dict:
    """Full depth, fp32 policy: BATCH prompts of XL_CHECK_PROMPT tokens
    through the static engine, through the kernels and through
    ``impl="ref"`` under the same draws, XL_CHECK_NEW new tokens: every
    step's logits within 1e-3 relative and the greedy tokens equal."""
    from repro_torch import kernels as K
    from repro_torch.launch.serve import get_engine
    dbm, params, gen = model
    _, G = paged_layers(dbm)
    prompts = prompts_np(dbm.cfg.vocab_size, 1)[0][:, :XL_CHECK_PROMPT]
    z, _ = get_engine(dbm, precision="fp32", chunk_size=CHUNK).draw(
        XL_CHECK_NEW, BATCH, gen, dev)
    plain = dbm.model.logits
    runs = {}
    for impl in ("kernels", "ref"):
        logits = []

        def readout(p, h, logits=logits):
            logits.append(plain(p, h))
            return logits[-1]
        dbm.model.logits = readout
        K.reset_launch_counts()
        try:
            eng = get_engine(dbm, precision="fp32", impl=impl,
                             chunk_size=CHUNK)
            out = eng.generate(params, prompts, XL_CHECK_NEW, z0=z)
            eng.last_kv = None
        finally:
            del dbm.model.logits
        runs[impl] = (out, torch.stack([x[:, 0].float() for x in logits]),
                      K.launch_counts())
    counts = runs["kernels"][2]
    check_counts("xlstm fp32", counts,
                 expected_counts(gate_residual=XL_CHECK_NEW * G))
    check_counts("xlstm fp32, plain", runs["ref"][2], expected_counts())
    lk, lr = runs["kernels"][1], runs["ref"][1]
    rel = ((lk - lr).abs().max() / lr.abs().max()).item()
    equal = torch.equal(runs["kernels"][0], runs["ref"][0])
    say(f"[xlstm] fp32 at full depth ({dbm.cfg.n_layers} layers), "
        f"{BATCH} prompts of {XL_CHECK_PROMPT} tokens, {XL_CHECK_NEW} new, "
        f"kernels vs plain versions: logits rel max|diff| {rel:.2e} (limit "
        f"1e-3) | greedy tokens {'equal' if equal else 'DIFFER'}")
    if not (rel <= 1e-3 and math.isfinite(rel)) or not equal:
        raise SmokeError(f"xlstm fp32 cross-check: logits {rel:.2e}, tokens "
                         f"equal {equal}")
    dbm.__dict__.pop("_serve_engines", None)
    return {"counts": counts, "logits_rel": rel}


def xl_refusals(dev, model) -> None:
    """The prefix cache and a ``SharedPagePool`` refuse the family (its
    state is per slot, not paged), as JAX's do."""
    from repro_torch import precision as precision_mod
    from repro_torch.launch.serve import SharedPagePool
    dbm = model[0]
    said = []
    for what, make in (
            ("prefix cache", lambda: cb_batcher(dev, model)),
            ("SharedPagePool", lambda: SharedPagePool(64).join(
                dbm, precision_mod.get_policy("bf16"), PSZ, dev, CB_SLOTS))):
        try:
            make()
        except ValueError as e:
            said.append(f"{what}: {e}")
            continue
        raise SmokeError(f"xlstm: the {what} took the family")
    say("[xlstm] refused, as in JAX: " + " | ".join(said))


def phase_xlstm(dev) -> dict:
    """Phase 22: xlstm-125m at full width and depth (see the module
    docstring), after phase 21 under its memory check: the static engine,
    the graphed batcher (recycled slots, a spill and restore), a one-slot
    reuse check, the server over HTTP, the refusals, fp32 greedy tokens
    through the kernels against ``impl="ref"``; memory back within 1 GiB
    of the phase's start."""
    t_phase = time.perf_counter()
    base = phase_start("xlstm")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = xl_model(dev)
    dbm, params, _ = model
    torch.cuda.synchronize()
    cfg, m = dbm.cfg, dbm.model
    n_params = sum(t.numel() for _, t in _leaves(params))
    d_in = int(cfg.xlstm.proj_factor * cfg.d_model)
    slot = xl_state_bytes(dbm)
    say(f"[xlstm] {cfg.name}: {cfg.n_layers} layers in {m.n_units} units of "
        f"one sLSTM and one mLSTM block; d={cfg.d_model} heads="
        f"{cfg.n_heads} (mLSTM d_in {d_in}, head dim {d_in // cfg.n_heads};"
        f" sLSTM head dim {cfg.d_model // cfg.n_heads}) vocab="
        f"{cfg.vocab_size}; {dbm.num_blocks} blocks {dbm.ranges}; "
        f"{n_params / 1e9:.4f} B params fp32 (reckoned 0.1915 B; 0.766 GB "
        f"served as they are) made in {time.perf_counter() - t0:.1f} s; "
        f"state {slot / 1e6:.2f} MB a slot (reckoned 14.2)")
    counts = {}
    static = xl_static(dev, model)
    add_counts(counts, static["counts"])
    cont, ledger = xl_continuous(dev, model)
    torch.cuda.empty_cache()
    reuse, _ = xl_slot_reuse(dev, model)
    add_counts(counts, srv_counts(ledger + reuse))
    xl_refusals(dev, model)
    fp32 = xl_fp32_check(dev, model)
    add_counts(counts, fp32["counts"])
    peak = torch.cuda.max_memory_allocated()
    say(f"[xlstm] peak memory {peak / 2**30:.3f} GiB (reckoned under 3 "
        f"GiB: {4 * n_params / 2**30:.3f} GiB of masters, "
        f"{CB_SLOTS * slot / 2**30:.3f} GiB of state a batcher, the graphs' "
        f"pools) of "
        f"{torch.cuda.get_device_properties(dev).total_memory / 2**30:.1f}")
    del model, dbm, params, m
    phase_end("xlstm", base)
    took = time.perf_counter() - t_phase
    say(f"[xlstm] phase 22 took {took:.1f} s | launches {counts}")
    return {"counts": counts, "static": static, "continuous": cont,
            "peak": peak, "fp32_rel": fp32["logits_rel"], "seconds": took}


# ---------------------------------------------------------------------------
# 23. xlstm-125m trained at full width and depth
# ---------------------------------------------------------------------------

def xl_train_bound(dbm, params, units: int, batch: int, seq: int,
                   two_pass: bool) -> tuple:
    """(ms, "bytes" or "operations") of the least device time of one
    xLSTM training step over ``units`` units (a DB step's block,
    ``two_pass``, or the e2e step's every unit) at ``batch`` x ``seq``
    tokens, from the shapes: the larger of bytes over 3.35 TB/s and flops
    over the fp32 peak (the family computes in fp32). Flops: 6 N D over
    the units' params N and the tokens of both streams (two-pass) or of
    one; the readout's CE, 6 d vocab a token; the mLSTM's quadratic terms,
    three times their forward (forward and backward), the causal half
    only: the parallel form (S <= 512) 2 B S^2 d_in, a chunked pass (the
    clean stream past 512 tokens; the two-pass history query at every
    length) 2 B S Q d_in within chunks of Q = 256 plus 4 B S hd d_in
    against the carried state. Bytes: the trained params (the units and
    the periphery), their gradients and both AdamW moments, each read and
    written once (32 bytes a param). The AdaLN heads act once an example
    on σ, on no token (and not at all in the e2e step): their params
    count in the bytes, not in 6 N D."""
    from repro_torch.nn.init import tree_items
    cfg = dbm.cfg
    leaves = list(tree_items(params))
    n_units = dbm.model.n_units
    per_unit = sum(x.numel() for p, x in leaves if p[0] == "units") / n_units
    per_unit_tok = sum(x.numel() for p, x in leaves
                       if p[0] == "units" and "adaln" not in p) / n_units
    periphery = sum(x.numel() for p, x in leaves if p[0] != "units")
    d_in = int(cfg.xlstm.proj_factor * cfg.d_model)
    hd = d_in // cfg.n_heads
    tokens = batch * seq

    def chunked(q: int) -> float:
        return 2 * tokens * min(q, seq) * d_in + 4 * tokens * hd * d_in
    clean = chunked(256) if seq > 512 else 2 * tokens * seq * d_in
    quad = 3 * units * (clean + (chunked(256) if two_pass else 0))
    flops = (6 * per_unit_tok * units * tokens * (2 if two_pass else 1)
             + 6 * cfg.d_model * cfg.vocab_size * tokens + quad)
    return bound(32 * (per_unit * units + periphery), flops, PEAK_FP32)


def xl_step_line(tag: str, what: str, wall_s: float, device_ms: float,
                 b: tuple, prof=None) -> dict:
    """Print and return a step's wall and device ms beside its bound and,
    where profiled, its busy share."""
    busy = (f" | busy {prof['device_ms']:.1f} of {prof['wall_ms']:.1f} ms "
            f"under the profiler "
            f"({100 * prof['device_ms'] / prof['wall_ms']:.1f}%)"
            if prof else "")
    say(f"[{tag}] {what}: wall {wall_s * 1e3:.1f} ms, device (events) "
        f"{device_ms:.1f} ms, bound {b[0]:.3f} ms ({b[1]}; wall "
        f"{wall_s * 1e3 / b[0]:.1f}x the bound){busy}")
    return {"wall_ms": wall_s * 1e3, "device_ms": device_ms,
            "bound_ms": b[0], "bound_by": b[1],
            "busy_share": (prof["device_ms"] / prof["wall_ms"]
                           if prof else None)}


def phase_xlstm_train(dev) -> dict:
    """Phase 23: xlstm-125m trained at full width and depth (``xl_model``:
    6 units in 3 blocks of 2, random fp32 weights, AdaLN heads
    randomised), bf16 policy (the family computes in fp32), after phase 22
    under its memory check. ``block_loss`` takes the two-pass route for the
    family. ``resident_db_steps`` at TRAIN_BATCH x TRAIN_SEQ ``MarkovLM``
    tokens (every block's AdamW state resident, one step a block, two
    gate-residual calls a unit forward and backward), one DB step at
    XL_LONG_BATCH x XL_LONG_SEQ (the clean mLSTM in its chunked form), one
    two_pass x l2 DB step (the EDM-loss kernels), ``e2e_steps`` (no σ: no
    kernel); each step's wall beside its bound (``xl_train_bound``) and,
    but for the l2 step (the DB step's work and the EDM-loss kernels),
    its busy share under the profiler. Every timed step follows a warm-up
    step of its own shape and mode (the e2e step's train-mode
    ``apply_units`` over 6 units allocates GiBs its first time). Then one fp32 DB step of block 0 through the kernels
    against ``impl="ref"``, every trained leaf's moment within 1e-4;
    memory back within 1 GiB of the phase's start."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import MarkovLM
    tag = "xlstm-train"
    t_phase = time.perf_counter()
    base = phase_start(tag)
    torch.cuda.reset_peak_memory_stats()
    model = xl_model(dev)
    dbm, params, gen = model
    cfg = dbm.cfg
    size = dbm.ranges[0][1]
    say(f"[{tag}] {cfg.name} at full width and depth: {dbm.model.n_units} "
        f"units in {dbm.num_blocks} blocks {dbm.ranges}, causal_mode "
        f"{dbm.causal_mode}, loss {dbm.db.loss}; "
        f"{sum(t.numel() for _, t in _leaves(params)) / 1e9:.4f} B params "
        "fp32")
    tcfg = TrainConfig(steps=100, warmup_steps=10, lr=1e-4)
    lm = MarkovLM(vocab_size=cfg.vocab_size, seed=7)
    db = resident_db_steps(dbm, params, gen, tcfg,
                           lm.iterator(TRAIN_BATCH, TRAIN_SEQ), tag)
    peaks = {"db": torch.cuda.max_memory_allocated()}
    b_db = xl_train_bound(dbm, params, size, TRAIN_BATCH, TRAIN_SEQ, True)
    lines = {"db": [xl_step_line(
        tag, f"DB step block {r['block']} ({TRAIN_BATCH}x{TRAIN_SEQ})",
        r["wall_s"], r["device_ms"], b_db,
        db["db_profile"] if r["block"] == 0 else None) for r in db["db"]]}
    torch.cuda.reset_peak_memory_stats()
    long = two_pass_step(model, tcfg,
                         lm.iterator(XL_LONG_BATCH, XL_LONG_SEQ), tag)
    peaks["long"] = torch.cuda.max_memory_allocated()
    lines["long"] = xl_step_line(
        tag, f"DB step block 0 ({XL_LONG_BATCH}x{XL_LONG_SEQ})",
        long["wall_s"], long["device_ms"],
        xl_train_bound(dbm, params, size, XL_LONG_BATCH, XL_LONG_SEQ, True),
        long["profile"])
    torch.cuda.reset_peak_memory_stats()
    l2 = two_pass_step(two_pass_view(model), tcfg,
                       lm.iterator(TRAIN_BATCH, TRAIN_SEQ), tag,
                       profile=False)
    peaks["l2"] = torch.cuda.max_memory_allocated()
    lines["l2"] = xl_step_line(
        tag, f"two_pass x l2 DB step block 0 ({TRAIN_BATCH}x{TRAIN_SEQ})",
        l2["wall_s"], l2["device_ms"], b_db)
    torch.cuda.reset_peak_memory_stats()
    e2e = e2e_steps(dbm, params, tcfg, lm.iterator(TRAIN_BATCH, TRAIN_SEQ),
                    tag)
    peaks["e2e"] = torch.cuda.max_memory_allocated()
    lines["e2e"] = xl_step_line(
        tag, f"e2e step ({TRAIN_BATCH}x{TRAIN_SEQ})", e2e["wall_s"],
        e2e["device_ms"],
        xl_train_bound(dbm, params, dbm.model.n_units, TRAIN_BATCH,
                       TRAIN_SEQ, False), e2e["profile"])
    counts = {}
    for part in (db, long, l2, e2e):
        add_counts(counts, part["launches"])
    total = torch.cuda.get_device_properties(dev).total_memory
    say(f"[{tag}] peak memory (GiB): "
        + ", ".join(f"{k} {v / 2**30:.2f}" for k, v in peaks.items())
        + f" of {total / 2**30:.1f}; nvidia-smi (sm MHz, W, limit, C): "
        f"{gpu_query('clocks.sm,power.draw,power.limit,temperature.gpu')}")
    cross = db_crosscheck(dev, model, "xlstm two-pass ce", None,
                          stack="units", limit=1e-4)
    del model, dbm, params, gen
    phase_end(tag, base)
    took = time.perf_counter() - t_phase
    say(f"[{tag}] phase 23 took {took:.1f} s | launches {counts}")
    return {"counts": counts, "steps": lines, "peaks": peaks,
            "crosscheck": cross, "seconds": took}


OFF_PATH = {"euler_bwd"}


# ---------------------------------------------------------------------------
# 24. the dense-cache serving path: stablelm-1.6b and xlstm-125m at full
#     width, a sliding-window ring at h2o-danube3-4b's attention dims
# ---------------------------------------------------------------------------

# (a): the tokens committed one at a time and the bf16 serve steps after
# them (the cache holds both); (a)'s fp32 check and (b): greedy steps;
# (c): ring positions before, at and past the wrap of a 4096-slot ring
DENSE_PREFIX, DENSE_STEPS, DENSE_CHECK_NEW = 128, 32, 16
RING_POS = (100, 4095, 4096, 9000)
# (a): the bf16 per-token commits against the bf16 prefill, largest
# |diff| / max |ref| of a leaf (a wrong slot or position is O(1)); the
# fp32 ones within JAX's own bound (tests/test_models_smoke.py)
DENSE_BF16_CACHE_REL, DENSE_FP32_CACHE_ABS = 5e-2, 2e-3


def dense_commits(dbm, params, cache, tokens, precision, impl) -> None:
    """Commit ``tokens`` (B, n) one at a time at positions 0..n-1 into the
    dense ``cache``, in place."""
    ctx = dbm.dense_ctx(0, precision=precision, impl=impl)
    for t in range(tokens.shape[1]):
        ctx.pos = t
        dbm.commit_token(params, cache, tokens[:, t:t + 1], ctx)


def dense_steps(dbm, params, cache, pos0: int, z, precision, impl,
                step_ms=None):
    """len(z) greedy dense serve steps from position ``pos0``: (tokens (B,
    n), logits (n, B, V) fp32); each step's host ms (synchronised) into
    ``step_ms`` where given."""
    toks, logits = [], []
    for t in range(z.shape[0]):
        t0 = time.perf_counter()
        tok, cache, lg = dbm.serve_step(params, cache, pos0 + t, z0=z[t],
                                        precision=precision, impl=impl,
                                        return_logits=True)
        if step_ms is not None:
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        toks.append(tok)
        logits.append(lg.float())
    return torch.stack(toks, dim=1), torch.stack(logits)


def cache_gaps(got, want, n=None) -> list:
    """Per leaf of two alike caches: (max |diff|, max |diff| / max |ref|);
    ``n``: got's KV leaves read at their first n positions (axis -3)."""
    from repro_torch.nn import cache as KVC
    out = []
    for g, w in zip(KVC.cache_tensors(got), KVC.cache_tensors(want)):
        if n is not None and g.shape != w.shape:
            g = g[..., :n, :, :]
        if g.shape != w.shape:
            raise SmokeError(f"cache leaf {tuple(g.shape)} against "
                             f"{tuple(w.shape)}")
        d = (g.float() - w.float()).abs().max().item()
        out.append((d, d / max(w.float().abs().max().item(), 1e-30)))
    return out


def dense_prefill_bound(dbm, params, S: int):
    """Least device time of the bf16 prefill of BATCH x S tokens (larger of
    bytes over 3.35 TB/s and flops at the bf16 peak): the attention and MLP
    weights read once in bf16, every layer's keys and values written, the
    fp32 head read once for the last position; the weights' flops for
    every token and the causal attention's."""
    cfg, L = dbm.cfg, dbm.cfg.n_layers
    commit = sum(t.numel() for p, t in _leaves(params["layers"])
                 if p[0] in ("attn", "mlp"))
    head = params["head"]["w"].numel()
    kv_row = 2 * cfg.n_kv_heads * cfg.head_dim * 2
    attn = 4 * L * BATCH * cfg.n_heads * cfg.head_dim * S * (S + 1) / 2
    return bound(commit * 2 + L * BATCH * S * kv_row + head * 4,
                 2 * commit * BATCH * S + attn + 2 * BATCH * head,
                 PEAK_BF16)


def dense_view_case(label, *, C, KV, G, hd, q_dtype, length, dev, gen):
    """The flash-decode kernel over a dense (BATCH, C, KV, hd) bf16 cache
    viewed as pages (``cache.dense_to_paged``: one page of C keys a slot)
    at ``length`` committed keys, against its plain version, timed by
    CUDA-graph replay over caches that together exceed the L2."""
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.nn import cache as KVC

    def view():
        k, v = (torch.randn((BATCH, C, KV, hd), generator=gen,
                            device=dev).bfloat16() for _ in range(2))
        return KVC.dense_to_paged(k, v)
    first = view()
    nbytes = 2 * first[0].k.numel() * 2
    sets = [first] + [view() for _ in range(rotations(nbytes) - 1)]
    lens = torch.full((BATCH,), length, dtype=torch.int32, device=dev)
    q = torch.randn((BATCH, KV, G, hd), generator=gen,
                    device=dev).to(q_dtype)
    call_k = lambda i: FD.flash_decode(q, sets[i][0].k, sets[i][0].v,
                                       sets[i][1], lens)
    call_r = lambda i: FD.flash_decode_ref(q, sets[i][0].k, sets[i][0].v,
                                           sets[i][1], lens)
    got = call_k(0)
    torch.cuda.synchronize()
    err = compare(label, got, call_r(0))
    ms, e_ms = device_ms(call_k, len(sets)), eager_ms(call_k, len(sets))
    plain_ms = device_ms(call_r, len(sets), calls=4, reps=3)
    nb, flops, peak = attn_work(q, first[0].k, lens, 1, None, False, False)
    bound_ms, by = bound(nb, flops, peak)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ns = FD.decode_splits(BATCH * KV, FD.max_tiles(C, None), sms)
    say(f"[dense] {label} [paged_decode_kernel over the identity view, "
        f"page {C} keys, {ns} blocks a pair]: max|err| {err:.2e} | kernel "
        f"{ms:.4f} ms device ({e_ms:.4f} ms per eager call) | bound "
        f"{bound_ms:.4f} ms ({by}; {nb / 1e6:.2f} MB, {flops / 1e9:.3f} "
        f"GFLOP) | plain {plain_ms:.3f} ms | library none")
    return {"case": label, "max_abs_err": err, "ms": ms, "eager_ms": e_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
            "library_ms": None, "bytes": nb, "flops": flops}


def dense_stablelm(dev) -> dict:
    """(a) stablelm-1.6b at full width and depth, bf16 policy, the kernels:
    ``prefill`` of BATCH x PROMPT (one flash-attention forward a layer) and
    ``prefill_probe(k=1)``; DENSE_PREFIX tokens committed one at a time
    into ``init_cache(BATCH, DENSE_PREFIX + DENSE_STEPS)``, held to the
    prefill of the same tokens; DENSE_STEPS greedy ``serve_step``s; ms and
    busy share of both beside their bounds, the peak. Then fp32: the same
    commits held to the fp32 prefill within JAX's bound, DENSE_CHECK_NEW
    greedy steps through the kernels and through ``impl="ref"`` (logits
    within 1e-3) and the paged static engine's on the same z: the same
    tokens. Launches equal to each run's arithmetic."""
    from repro_torch import kernels as K
    from repro_torch.launch.serve import get_engine
    cfg, dbm, params, gen = build_model(dev)
    m, L = dbm.model, cfg.n_layers
    prompts, _ = prompts_np(cfg.vocab_size)
    tokens = torch.as_tensor(prompts, device=dev)
    head = tokens[:, :DENSE_PREFIX]
    counts = {}

    def counted(tag, run, **expect):
        K.reset_launch_counts()
        out = run()
        torch.cuda.synchronize()
        got = K.launch_counts()
        check_counts(f"dense {tag}", got, expected_counts(**expect))
        add_counts(counts, got)
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dbm.prefill(params, tokens, impl="kernels", precision="bf16")  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, pre = counted("prefill", lambda: dbm.prefill(
        params, tokens, impl="kernels", precision="bf16"),
        flash_attention_fwd=L)
    pre_ms = (time.perf_counter() - t0) * 1e3
    if not torch.isfinite(logits).all() or any(
            not torch.isfinite(t).all() for t in pre.values()):
        raise SmokeError("dense prefill: non-finite logits or cache")
    p_wall, p_busy, _ = device_busy(lambda: dbm.prefill(
        params, tokens, impl="kernels", precision="bf16"))
    plog, sub = counted("prefill_probe", lambda: dbm.prefill_probe(
        params, tokens, 1, impl="kernels", precision="bf16"),
        flash_attention_fwd=1)
    probe_gap = max(r for _, r in cache_gaps(sub, {k: t[:1] for k, t in
                                                   pre.items()}))
    if not (probe_gap <= BF16_ULP and torch.isfinite(plog).all()):
        raise SmokeError(f"dense prefill_probe: unit 0 {probe_gap:.2e} "
                         "from the prefill's")
    cache = m.init_cache(BATCH, DENSE_PREFIX + DENSE_STEPS, torch.bfloat16,
                         device=dev)
    t0 = time.perf_counter()
    counted("commits", lambda: dense_commits(dbm, params, cache, head,
                                             "bf16", "kernels"),
            flash_decode=DENSE_PREFIX * L)
    commit_ms = (time.perf_counter() - t0) * 1e3 / DENSE_PREFIX
    _, pre_head = counted("prefill of the commits' tokens", lambda:
                          dbm.prefill(params, head, impl="kernels",
                                      precision="bf16"),
                          flash_attention_fwd=L)
    gaps = cache_gaps(cache, pre_head, DENSE_PREFIX)
    if not max(r for _, r in gaps) <= DENSE_BF16_CACHE_REL:
        raise SmokeError(f"dense bf16 commits against the prefill: {gaps}")
    eng = get_engine(dbm, precision="bf16", chunk_size=CHUNK)
    z, _ = eng.draw(DENSE_STEPS + 4, BATCH, gen, dev)
    spare = {k: t.clone() for k, t in cache.items()}
    dbm.serve_step(params, spare, DENSE_PREFIX, z0=z[0],
                   precision="bf16")                              # warm-up
    step_ms = []
    toks, _ = counted("serve steps", lambda: dense_steps(
        dbm, params, cache, DENSE_PREFIX, z[:DENSE_STEPS], "bf16",
        "kernels", step_ms), flash_decode=DENSE_STEPS * 2 * L,
        gate_residual=DENSE_STEPS * 2 * L)
    if not ((toks >= 0) & (toks < cfg.vocab_size)).all() or any(
            not torch.isfinite(t).all() for t in cache.values()):
        raise SmokeError("dense serve steps: token outside the vocabulary "
                         "or a non-finite cache")
    s_wall, s_busy, top = counted("profiled serve steps", lambda: device_busy(
        lambda: dense_steps(dbm, params, spare, DENSE_PREFIX,
                            z[DENSE_STEPS:], "bf16", "kernels")),
        flash_decode=4 * 2 * L, gate_residual=4 * 2 * L)
    peak = torch.cuda.max_memory_allocated()
    del spare
    lb = serve_bounds(dbm, params, [DENSE_PREFIX] * BATCH)
    pb = dense_prefill_bound(dbm, params, PROMPT)
    med = statistics.median(step_ms)
    say(f"[dense] (a) {cfg.name} at full width and depth ({L} layers, d "
        f"{cfg.d_model}), bf16 policy, kernels: prefill {BATCH} x {PROMPT} "
        f"{pre_ms:.1f} ms (bound {pb[0]:.3f} ms, {pb[1]}; busy "
        f"{100 * p_busy / p_wall:.1f}% under the profiler) | "
        f"prefill_probe(k=1): unit 0 within {probe_gap:.2e} of the prefill's"
        f" | {DENSE_PREFIX} per-token commits {commit_ms:.2f} ms each, caches"
        f" against the prefill of the same tokens: worst leaf "
        f"{max(r for _, r in gaps):.2e} relative (limit "
        f"{DENSE_BF16_CACHE_REL:g})")
    say(f"[dense] (a) {DENSE_STEPS} serve steps from position "
        f"{DENSE_PREFIX}: median {med:.2f} ms a step (min "
        f"{min(step_ms):.2f}, max {max(step_ms):.2f}; bound "
        f"{lb['decode_step_ms']:.3f} ms, {lb['decode_step_by']}) | 4 steps "
        f"under the profiler: device busy {s_busy:.1f} ms of {s_wall:.1f} ms"
        f" ({100 * s_busy / s_wall:.1f}%) | peak memory "
        f"{peak / 2**30:.2f} GiB")
    for ms, count, key in top:
        say(f"[dense]   {ms:8.2f} ms  x{count:<6d} {key[:90]}")

    # fp32: per-token commits against the prefill; the dense step through
    # the kernels against impl="ref" and against the paged engine
    z32, _ = get_engine(dbm, precision="fp32", chunk_size=CHUNK).draw(
        DENSE_CHECK_NEW, BATCH, gen, dev)
    c32 = m.init_cache(BATCH, DENSE_PREFIX + DENSE_CHECK_NEW, torch.float32,
                       device=dev)
    counted("fp32 commits", lambda: dense_commits(
        dbm, params, c32, head, "fp32", "kernels"),
        flash_decode=DENSE_PREFIX * L)
    _, pre32 = counted("fp32 prefill", lambda: dbm.prefill(
        params, head, impl="kernels", precision="fp32"),
        flash_attention_fwd=L)
    gaps32 = cache_gaps(c32, pre32, DENSE_PREFIX)
    if not max(a for a, _ in gaps32) <= DENSE_FP32_CACHE_ABS:
        raise SmokeError(f"dense fp32 commits against the prefill: {gaps32}")
    del pre32
    r32 = {k: t.clone() for k, t in c32.items()}
    tk, lk = counted("fp32 serve steps", lambda: dense_steps(
        dbm, params, c32, DENSE_PREFIX, z32, "fp32", "kernels"),
        flash_decode=DENSE_CHECK_NEW * 2 * L,
        gate_residual=DENSE_CHECK_NEW * 2 * L)
    tr, lr = counted("fp32 serve steps, plain", lambda: dense_steps(
        dbm, params, r32, DENSE_PREFIX, z32, "fp32", "ref"))
    same = (tk == tr).all(dim=0)
    n_same = DENSE_CHECK_NEW if bool(same.all()) else int(
        torch.nonzero(~same)[0, 0]) + 1
    rel = ((lk[:n_same] - lr[:n_same]).abs().max()
           / lr[:n_same].abs().max()).item()
    peng = get_engine(dbm, precision="fp32", chunk_size=CHUNK)
    out = counted("fp32 paged engine", lambda: peng.generate(
        params, prompts[:, :DENSE_PREFIX], DENSE_CHECK_NEW, z0=z32),
        flash_prefill=-(-DENSE_PREFIX // CHUNK) * L,
        flash_decode=DENSE_CHECK_NEW * 2 * L,
        gate_residual=DENSE_CHECK_NEW * 2 * L)
    peng.last_kv = None
    paged_equal = torch.equal(tk.cpu(), out[:, DENSE_PREFIX:])
    say(f"[dense] (a) fp32: {DENSE_PREFIX} per-token commits against the "
        f"prefill: worst leaf {max(a for a, _ in gaps32):.2e} absolute "
        f"(limit {DENSE_FP32_CACHE_ABS:g}) | {DENSE_CHECK_NEW} greedy dense "
        f"steps, kernels against impl=\"ref\": logits rel max|diff| "
        f"{rel:.2e} over {n_same} steps (limit 1e-3), tokens "
        f"{'equal' if bool(same.all()) else 'DIFFER'} | against the paged "
        f"static engine on the same z: tokens "
        f"{'equal' if paged_equal else 'DIFFER'}")
    if not (rel <= 1e-3 and math.isfinite(rel)) or not paged_equal:
        raise SmokeError(f"dense fp32 check: logits {rel:.2e}, tokens equal "
                         f"to the paged engine's {paged_equal}")
    dbm.__dict__.pop("_serve_engines", None)
    return {"counts": counts, "prefill_ms": pre_ms, "prefill_bound": pb,
            "step_ms": med, "step_bound": lb["decode_step_ms"],
            "busy": s_busy / s_wall, "peak": peak, "fp32_rel": rel}


def dense_xlstm(dev) -> dict:
    """(b) xlstm-125m at full width and depth: the dense ``prefill`` of
    BATCH x PROMPT (the sequence forms: ``slstm_fwd``, the chunked
    ``mlstm_fwd`` with its final state) against the paged engine's chunk
    chain (``commit_prompt_chunk``, per-token steps) on the same prompts,
    fp32: every state leaf within 1e-4 relative, both walls; then
    DENSE_CHECK_NEW greedy dense ``serve_step``s from the prefill's state
    and the paged engine's decode from the chain's, on the same z: the same
    tokens."""
    from repro_torch import kernels as K
    from repro_torch.launch.serve import get_engine
    from repro_torch.nn import cache as KVC
    dbm, params, gen = xl_model(dev)
    m = dbm.model
    _, G = paged_layers(dbm)
    prompts, _ = prompts_np(dbm.cfg.vocab_size)
    tokens = torch.as_tensor(prompts, device=dev)
    eng = get_engine(dbm, precision="fp32", chunk_size=CHUNK)
    table = KVC.identity_page_table(BATCH, 1, device=dev)
    plens = torch.full((BATCH,), PROMPT, dtype=torch.int32, device=dev)

    def chain():
        kv = m.init_paged_cache(BATCH, 1, PSZ, device=dev)
        lens = torch.zeros((BATCH,), dtype=torch.int32, device=dev)
        return eng.run_prefill(params, kv, table, lens, tokens, plens)
    dbm.prefill(params, tokens[:, :CHUNK], precision="fp32")     # warm-up
    eng.run_prefill(params, m.init_paged_cache(BATCH, 1, PSZ, device=dev),
                    table, torch.zeros((BATCH,), dtype=torch.int32,
                                       device=dev),
                    tokens[:, :CHUNK], torch.full_like(plens, CHUNK))
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, dense = dbm.prefill(params, tokens, precision="fp32")
    torch.cuda.synchronize()
    t_dense = time.perf_counter() - t0
    t0 = time.perf_counter()
    kv, lens = chain()
    torch.cuda.synchronize()
    t_chain = time.perf_counter() - t0
    check_counts("xlstm prefill and chain", K.launch_counts(),
                 expected_counts())
    gaps = cache_gaps(dense, kv)
    worst = max(r for _, r in gaps)
    z, _ = eng.draw(DENSE_CHECK_NEW, BATCH, gen, dev)
    K.reset_launch_counts()
    td, _ = dense_steps(dbm, params, dense, PROMPT, z, "fp32", "kernels")
    _, _, tp = eng.decode(params, kv, table, lens, lens + DENSE_CHECK_NEW,
                          DENSE_CHECK_NEW, z0=z)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    check_counts("xlstm dense and paged steps", counts, expected_counts(
        gate_residual=2 * DENSE_CHECK_NEW * G))
    equal = torch.equal(td, tp)
    lb = xl_bounds(dbm, params)
    say(f"[dense] (b) {dbm.cfg.name} at full width and depth, fp32: prefill "
        f"of {BATCH} x {PROMPT} through the sequence forms {t_dense:.3f} s "
        f"against the paged chunk chain (per-token steps, "
        f"{-(-PROMPT // CHUNK)} chunks of {CHUNK}) {t_chain:.3f} s (chain "
        f"bound {-(-PROMPT // CHUNK) * lb['chunk_ms']:.3f} ms, "
        f"{lb['chunk_by']}) | states: worst leaf {worst:.2e} relative (limit"
        f" 1e-4) | {DENSE_CHECK_NEW} greedy steps from each: tokens "
        f"{'equal' if equal else 'DIFFER'}")
    if not worst <= 1e-4 or not equal:
        raise SmokeError(f"xlstm dense prefill: states {gaps}, tokens equal "
                         f"{equal}")
    dbm.__dict__.pop("_serve_engines", None)
    return {"counts": counts, "dense_s": t_dense, "chain_s": t_chain,
            "state_rel": worst}


def dense_ring(dev) -> float:
    """(c) ``decode_attention`` on a sliding-window ring at
    h2o-danube3-4b's attention dims (32 query heads on 8 KV heads of 120,
    window 4096 = C, BATCH slots), random weights with wo the identity (so
    the output is the attention itself), probes (``commit=False``): the
    kernel route (the ring un-rotated, the kernel over the identity view)
    against the reference route at RING_POS, in bf16 and fp32, within the
    kernel's tolerance; the ring bit-unchanged. Returns the worst error."""
    from repro_torch.configs import get_config
    from repro_torch.nn import attention as A
    cfg = get_config(H2O_ARCH)
    dims = A.AttnDims(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                      cfg.rope_theta)
    d, hq = cfg.d_model, cfg.n_heads * cfg.head_dim
    C = cfg.sliding_window
    gen = torch.Generator(device=dev).manual_seed(24)
    w = lambda n: torch.randn((d, n), generator=gen, device=dev) / d ** 0.5
    p32 = {"wq": w(hq), "wk": w(cfg.n_kv_heads * cfg.head_dim),
           "wv": w(cfg.n_kv_heads * cfg.head_dim),
           "wo": torch.eye(hq, d, device=dev)}
    kv_shape = (BATCH, C, cfg.n_kv_heads, cfg.head_dim)
    worst, said = 0.0, []
    for dt in (torch.bfloat16, torch.float32):
        p = {k: t.to(dt) for k, t in p32.items()}
        ring = {k: torch.randn(kv_shape, generator=gen, device=dev).to(dt)
                for k in ("k", "v")}
        before = {k: t.clone() for k, t in ring.items()}
        x = torch.randn((BATCH, 1, d), generator=gen, device=dev).to(dt)
        for pos in RING_POS:
            got, _ = A.decode_attention(p, x, dims, ring, pos, window=C,
                                        impl="kernels", commit=False)
            want, _ = A.decode_attention(p, x, dims, ring, pos, window=C,
                                         impl="ref", commit=False)
            torch.cuda.synchronize()
            err = compare(f"ring {str(dt)[6:]} pos {pos}", got, want,
                          bf16_rounding=True)
            worst = max(worst, err)
            said.append(f"{str(dt)[6:]} {pos}: {err:.2e}")
        if not all(torch.equal(ring[k], before[k]) for k in ring):
            raise SmokeError("ring probe wrote the cache")
    say(f"[dense] (c) ring of {C} slots at {H2O_ARCH}'s dims ({cfg.n_heads} "
        f"heads on {cfg.n_kv_heads} of {cfg.head_dim}), kernels against "
        f"impl=\"ref\", max|err| by dtype and position: " + ", ".join(said)
        + " (limit 2e-4 + 2e-4 |ref|, bf16 2e-4 + 2^-7 |ref|); the ring "
        "bit-unchanged")
    return worst


def phase_dense(dev) -> dict:
    """Phase 24: the dense-cache serving path (see the module docstring),
    after phase 23 under its memory check: (a) stablelm-1.6b, (b)
    xlstm-125m, (c) the ring check; then the flash-decode kernel over the
    identity view at (a)'s probe shape and (c)'s bf16 ring against its
    plain version, timed (cases of the kernels line, not main-path
    launches); memory back within 1 GiB."""
    t_phase = time.perf_counter()
    base = phase_start("dense")
    counts = {}
    a = dense_stablelm(dev)
    add_counts(counts, a["counts"])
    gc.collect()
    torch.cuda.empty_cache()
    b = dense_xlstm(dev)
    add_counts(counts, b["counts"])
    gc.collect()
    torch.cuda.empty_cache()
    ring = dense_ring(dev)
    gen = torch.Generator(device=dev).manual_seed(25)
    cases = [dense_view_case("(d) stablelm dense probe, fp32 q over bf16 "
                             f"C={DENSE_PREFIX + DENSE_STEPS}",
                             C=DENSE_PREFIX + DENSE_STEPS, KV=32, G=1,
                             hd=64, q_dtype=torch.float32,
                             length=DENSE_PREFIX + DENSE_STEPS // 2,
                             dev=dev, gen=gen),
             dense_view_case("(h) h2o ring un-rotated, bf16 C=4096", C=4096,
                             KV=8, G=4, hd=120, q_dtype=torch.bfloat16,
                             length=4095, dev=dev, gen=gen)]
    phase_end("dense", base)
    took = time.perf_counter() - t_phase
    say(f"[dense] phase 24 took {took:.1f} s | launches {counts}")
    return {"counts": counts, "cases": cases, "stablelm": a, "xlstm": b,
            "ring_err": ring, "seconds": took}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run on the "
              "card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    dev = torch.device("cuda", 0)
    t_all = t_lap = time.perf_counter()

    def lap(phases: str) -> None:
        """The seconds since the last lap, on a line of its own."""
        nonlocal t_lap
        now = time.perf_counter()
        say(f"[time] phase {phases}: {now - t_lap:.1f} s (script "
            f"{now - t_all:.1f} s)")
        t_lap = now

    phase_device()
    phase_build()
    lap("1-2")
    rows = phase_kernels(dev)
    rows.update(phase_rowwise(dev))
    rows.update(phase_attention(dev))
    rows.update(phase_euler(dev))
    lap("3")
    serve = phase_serve(dev)
    model = serve.pop("model")
    phase_profile(dev, model)
    lap("4")
    phase_crosscheck(dev, model)
    phase_crosscheck_bf16(dev, model)
    lap("5")
    continuous = phase_continuous(dev, model)
    lap("5b")
    server = phase_server(dev, model, continuous)
    lap("5c")
    disagg = phase_disagg(dev, model, continuous, server)
    lap("5d")
    train = phase_train(dev, model)
    db_crosscheck(dev, model, "concat ce", [("attn", "wq")])
    lap("6-7")
    del model                      # stablelm's masters and caches
    gc.collect()
    torch.cuda.empty_cache()
    two_pass = phase_two_pass(dev)
    model = two_pass.pop("model")
    db_crosscheck(dev, model, "two-pass l2",
                  [("attn", "wq"), ("mlp", "wg"), ("adaln", "w")])
    del model
    gc.collect()
    torch.cuda.empty_cache()
    lap("8-9")
    dit = phase_dit(dev)
    lap("10")
    huginn = phase_huginn(dev)
    lap("11")
    vit = phase_vit(dev)
    lap("12")
    mdm = phase_mdm(dev)
    lap("13")
    block_parallel = phase_block_parallel(dev, train)
    phase_block_parallel_crosscheck(dev)
    lap("14a")
    runner = phase_runner(dev)
    lap("14b")
    mesh = phase_mesh(dev)
    lap("14c")
    vlm = phase_vlm(dev)
    lap("15")
    hybrid = phase_hybrid(dev)
    lap("16")
    hybrid_train = phase_hybrid_train(dev)
    lap("17")
    h2o = phase_h2o(dev)
    lap("18")
    whisper = phase_whisper(dev)
    lap("19")
    vlm_train = phase_vlm_train(dev)
    lap("20")
    moe = phase_moe(dev)
    lap("21")
    xlstm = phase_xlstm(dev)
    lap("22")
    xlstm_train = phase_xlstm_train(dev)
    lap("23")
    dense = phase_dense(dev)
    rows["flash_decode"].extend(dense["cases"])
    lap("24")
    launches = {}
    for counts in (serve["counts"], continuous["counts"], server["counts"],
                   disagg["counts"], train["launches"],
                   two_pass["launches"], dit["launches"],
                   huginn["launches"], vit["launches"], mdm["launches"],
                   block_parallel["launches"], runner["launches"],
                   mesh["launches"],
                   vlm["counts"], hybrid["counts"],
                   hybrid_train["counts"], h2o["counts"],
                   whisper["counts"], vlm_train["counts"], moe["counts"],
                   xlstm["counts"], xlstm_train["counts"], dense["counts"]):
        add_counts(launches, counts)
    missing = sorted(n for n in SOURCES
                     if n not in OFF_PATH and launches.get(n, 0) == 0)
    if missing or sorted(rows) != sorted(SOURCES):
        raise SmokeError(f"kernels not launched on the main path: {missing}"
                         f"; checked in phase 3: {sorted(rows)}")
    kernels = []
    for name, cases in rows.items():
        main_case = cases[0]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1], "launches": launches.get(name, 0),
            **{k: main_case.get(k) for k in (
                "max_abs_err", "ms", "eager_ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "library_spread_ms")},
            "case": main_case["case"], "cases": cases[1:]})
    say(f"[done] all phases passed in {time.perf_counter() - t_all:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:        # a rank of phase 14c
        sys.exit(mesh_rank(int(sys.argv[2]), sys.argv[3]))
    sys.exit(main())
