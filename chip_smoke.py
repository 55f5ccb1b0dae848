#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py [--seed N]
    python3 chip_smoke.py --ab PARENT_CHECKOUT    # A/B against another checkout

Imports nothing of JAX or of the JAX package; needs one CUDA card and the
repository checkout beside it (``src/repro_torch``). Twenty-four main
paths run, through the hand-written kernels where they have attention: four
block-sparse attentions (paper Alg. 5) as a user calls them (phase 2f), the
trainable paged prefill (phase 2c),
paged serving (phases 3-4), dense-slot serving (phases 4b-4c) and training
(phases 5-6) of granite-3-2b, then training of bert-large with the paper's
LAMB recipe (phase 7), training of olmo-1b (phase 8), paged serving of
qwen3-32b (phase 9), the mixture-of-experts family: paged serving of
olmoe-1b-7b (phase 10) and of phi3.5-moe-42b-a6.6b (phase 11) and
training of olmoe-1b-7b (phase 12), and the state-space and hybrid
families: dense-slot serving and training of mamba2-2.7b (phase 13, no
attention kernel) and of hymba-1.5b (phase 14), the encoder-decoder:
model-level serving and training of seamless-m4t-medium (phase 15), and
the vision-language decoder: model-level serving and training of
phi-3-vision-4.2b at head_dim 96 (phase 16), tensor- and
sequence-parallel paged serving of granite-3-2b by ranks that share the
card (phase 17), and its sequence-sharded decode over a KV capacity or
page pool cut across such ranks (phase 22).
Phases:

1. print the card's name and power limit (nvidia-smi), then build every
   CUDA kernel of both paths from ``src/repro_torch/kernels/csrc`` (one
   nvcc per source, the five libraries started together), and, from
   ``-Xptxas -v`` compiles of ``flash_fwd.cu``, ``flash_fwd_sm90.cu``,
   ``flash_bwd.cu``, ``flash_bwd_sm90.cu`` and ``flash_decode.cu`` started
   beside the build, hold every ``flash_fwd_sm90_kernel`` (d 64, 96, 128;
   paged in both variants, contiguous with and without dropout in both)
   and every ``flash_bwd_dq_sm90_kernel`` / ``flash_bwd_dkv_sm90_kernel``
   (d 64, 96, 128; paged, contiguous with and without dropout) to wgmma
   (``HGMMA``), TMA
   loads (``UTMALDG``) and no spill, and count the tensor-core
   instructions (``HMMA``, ``cuobjdump -sass``) with the registers and
   spills of every bf16 ``flash_fwd_kernel`` (paged; contiguous, with and
   without dropout; both variants) and ``flash_bwd_dq_kernel`` /
   ``flash_bwd_dkv_kernel`` (paged, contiguous, contiguous with dropout),
   at every head dim (16, 32, 64, 96, 128): each must have some (no bf16
   forward and no bf16 backward runs the scalar body), and none may
   spill; then every ``flash_decode_kernel`` instantiation's registers,
   shared memory (static, and the dynamic size and ring stages its
   launcher gives it), spills and HMMA: none may spill, and every bf16 one
   runs on the tensor cores;
2. kernels: each kernel against its plain PyTorch version at the main
   path's shapes in bf16 (hq 32 / hkv 8 / d 64, page 16): a ~2k-token
   packed prefill with several documents (flash_fwd_sm90, the sm90 body
   that every bf16 forward at d 64 / 96 / 128 takes), a 256-row chunk
   against 1.5k-token paged prefixes (flash_fwd_paged_sm90), each beside
   flash_fwd.cu's mma.sync body on the same inputs (forced with
   ``_mma_body``; records ``flash_fwd`` / ``flash_fwd_paged``, marked
   ``"on_main_path": false``), decode at batch 8
   over ~1k-token contexts (flash_decode_paged: the whole decode, one
   launch that writes the split partials and merges them, its layout
   lowered beforehand; the plain version is the plain partials and the
   torch merge). Tolerances: max |o - o_plain| <= 2e-2 (bf16 output), m
   and l within 1e-2 relative, the decodes' split accumulators o_p within
   2e-2 once scaled by each split's max(1, l). Each is timed after
   warm-up, inputs rotated so the working set exceeds the 50 MB L2, as
   device time per call (``ms``: every kernel of the call summed by
   ``torch.profiler``) and as CUDA-event time per call (``call_ms``: the
   host's launch gaps included); the plain version is timed the same way
   (device time), and so is one ``scaled_dot_product_attention`` call with
   the equivalent boolean mask (``library_ms``; the port never calls it;
   for the two paged kernels
   SDPA runs on K/V gathered beforehand into a contiguous tensor, the
   gather not timed). At the training phase's per-layer shape in bf16 (q
   (4, 32, 2048, 64), k/v (4, 8, 2048, 64), causal, the segment ids of
   ``SyntheticLM(49155, 2048, 4, seed).batch_at(0)``): the forward against
   its plain version, the dq and dkv kernels fed the kernel forward's
   (o, m, l) against the plain backward fed the same (max |g - plain| /
   max |plain| <= 2e-2), a dropout_p = 0.1 forward + backward and a
   ``variant="paper"`` forward against the plain versions, two calls of
   the backward pair bit-identical (without and with dropout), each kernel
   timed (device time) beside its bound,
   its plain time and ``library_ms`` = the backward of SDPA alone
   (``torch.autograd.grad`` after one forward, boolean mask, GQA), and the
   pair's device time (dq + dkv) against it on a line of its own, beside
   the kernels' CTA walks. The pair is the body the path launches, the
   sm90 one (``flash_bwd_sm90.cu``, wgmma and TMA; records
   ``flash_bwd_dq_sm90`` / ``flash_bwd_dkv_sm90``), held and timed beside
   flash_bwd.cu's mma.sync body on the same residuals (forced with
   ``_mma_body``; records ``flash_bwd_dq`` / ``flash_bwd_dkv``, marked
   ``"on_main_path": false``: no main path launches that body, and the
   script checks that none does, nor the mma.sync forward); the forward
   and the pair are held and timed beside their mma.sync bodies (``mma_ms``)
   once per head dim and at the shapes PERF.md's prediction names
   (``MMA_SHAPES``), not at every shape. The walks: layout tiles a dq
   CTA visits, (q-block, head) items a dkv CTA visits, mean and max. The
   whole
   contiguous decode (flash_decode) at batch 8 over a 2048-slot
   cache, kv_len 900-1100, also with a window and with a kv_mask, against
   its plain version (SDPA over the cache with a boolean mask as library);
2c. paged backward: at flash_fwd_paged's shapes, one row per sequence,
   the first prefix page shared by both rows and dead slots: the paged dq
   and dkv kernels plus the fold kernel into pool shape against the plain
   backward (max |g - plain| / max |plain| <= 2e-2), untouched pages
   exactly zero, two calls bit-identical, one call of the whole backward
   under ``torch.cuda.set_sync_debug_mode("error")`` (no host sync), the
   fold bit-equal to ``fold_packed_to_pool``. The pair is the body the path
   launches, the sm90 one (records ``flash_bwd_dq_paged_sm90`` /
   ``flash_bwd_dkv_paged_sm90``), held and timed in turns beside
   flash_bwd.cu's mma.sync pair forced on the same residuals (records
   ``flash_bwd_dq_paged`` / ``flash_bwd_dkv_paged``, ``"on_main_path":
   false``, and ``mma_ms``), and again at qwen3-32b's heads (64 q / 8 kv
   of 128, the same chunks: dkv's 128-key tile at n_rep 8; the records'
   ``at_qwen3_heads``); each kernel timed (library: SDPA's backward on
   pre-gathered K/V; ``index_add_`` for the fold), the whole backward by
   device and by event time. Then the path itself: launch counters reset,
   one forward + backward through ``core.attention.paged_prefill_attention``
   with q and both pools requiring grad; the paged forward, the sm90 dq and
   dkv and the fold kernels must be > 0, the mma.sync paged pair's 0;
2d. kernels at the later paths' shapes (bf16, the same checks, times,
   bounds and SDPA yardsticks as phase 2b, without dropout and "paper"):
   the forward and the dq / dkv pair at train-bert's attention layer (q
   and k/v (56, 16, 512, 64), non-causal over the packed documents of its
   first batch) and at train-olmo's ((4, 16, 2048, 128), causal);
   and at train-hymba's ((4, 25/5, 2048, 64), causal with a sliding
   window of 1024 over its packed documents: whole tiles skipped; SDPA
   takes the window as a boolean mask, having no window argument);
   printed as ``at_shapes`` sub-entries of those kernels' records, each
   with its launches on its path (serve-qwen3's come with phase 9, the
   MoE serves' with phases 10-11, serve-hymba's with phase 14;
   train-olmoe's attention layer is train-olmo's, so it shares that entry
   with its own launches);
2f. block-sparse FlashAttention (paper §3.3, Alg. 5), GPT-2 small's
   attention (12 heads of 64, bf16) with a butterfly pattern of 128-row
   blocks (``masks.butterfly_block_layout``), which ``ops.flash_attention``
   refines into the kernels' 64-row tiles: four paths, each one forward +
   backward through ``ops.flash_attention(block_layout=...)`` with launch
   counters reset just before (flash_fwd_sm90, flash_bwd_dq_sm90 and
   flash_bwd_dkv_sm90 once each, nothing else): (4, 12, 4096, 64) non-causal, causal, and
   non-causal with a kv_mask (PARTIAL_DATA tiles), and (1, 12, 16384, 64)
   non-causal; then #1, #2 and #3 at each against their plain versions
   (``fwd_bwd_case``; at 16384 the plain versions by groups of heads,
   ``plain_by_heads``), timed beside the bound over the kept
   pairs, SDPA with the expanded element mask, and the dense #1 and pair
   at the same shape, with the density and the skipped tiles;
2g. the kernels at seamless-m4t-medium's shapes (16 heads of 64): #1, #2
   and #3 at train-seamless's (4, 16, 1024, 64) layers, non-causal (the
   encoder, the cross-attention) and causal (the decoder); #1 at
   serve-seamless's cross-attention prefill (64 rows against 1024); #7
   over its 1024-row cross cache and its 128-row self cache;
2h. the kernels at phi-3-vision-4.2b's shapes (32 heads of 96): #1, #2
   and #3 at train-phi3v's (4, 32, 2048, 96) causal layer; #1 at
   serve-phi3v's (4, 32, 640, 96) causal prefill; #7 for 4 lanes over its
   672-row cache;
2e. the MoE layer: one layer at olmoe-1b-7b's width (64 experts of d_ff
   1024, top-8, d 2048), bf16, forward + backward over 4 rows of 2048
   tokens: two calls bit-identical, a third under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host sync) with the
   same bits; its device time and the GEMM kernels' share of it beside
   their bound; then one SSM layer at mamba2-2.7b's width (80 heads of
   64, state 128, chunks of 256, d 2560), bf16, forward + backward over
   4 rows of 2048 tokens, with the same checks, its peak memory, and its
   time beside its bound (bf16 projections on the tensor cores, the
   SSD scan's products in float32);
3. parity: granite-3-2b at full width, 2 layers, float32: the same weights
   (drawn on the card) served by the engine on ``cuda`` (kernels) and on
   ``cpu`` (plain versions); greedy tokens must be identical (a divergence
   at a near-tie is reported with its step and top-2 logit margin);
4. serve: the published granite-3-2b (40 layers, bf16, random weights from
   the seed): 8 requests on 4 lanes, a 64-token shared prefix, one
   1024-token prompt prefilled in chunks of 256, 32 new tokens each. Every
   kernel's launch counter is reset just before and must be > 0 just
   after; prints tokens/s, TTFT p50 and peak memory beside the card. The
   same requests then run once more under ``torch.profiler``, with 8 new
   tokens each, for the device busy share and the kernels that take the
   most device time;
4b. dense parity: granite-3-2b at full width, 2 layers, float32, dense
   slot mode (``paged=False``) on ``cuda`` and on ``cpu``, and the paged
   engine on ``cuda``: greedy tokens identical;
4c. dense serve: the published model in dense slot mode with the decode
   kernel: 4 slots of 2048, 8 requests of 64-1024 prompt tokens, 32 new
   tokens each, drained requests prefilled packed; flash_fwd and
   flash_decode must be > 0 and flash_decode_paged 0; prints tokens/s,
   TTFT p50, decode step p50 and peak memory (not profiled);
5. train parity: granite-3-2b at full width, 2 layers, float32, seq 512,
   batch 2: the same random weights and ``SyntheticLM`` batches through two
   train steps on ``cuda`` (kernels) and on ``cpu`` (plain versions): losses
   within 1e-4 relative, layer 0's wq/wk/wv gradients of the first batch
   within 1e-3 scaled by their max; its card run launches the scalar
   (float32) body of flash_bwd.cu's contiguous pair and no sm90 kernel
   (a parity run, not a main path: its launches are counted nowhere);
6. train: the published granite-3-2b (40 layers, bf16, remat on) through
   the training launcher (``repro_torch.launch.train``: AdamW,
   warmup_cosine(3e-4, 20, steps), clip 1.0, deterministic), seq 2048,
   batch 4, 6 steps, step 1 excluded from the timing. Launch counters are
   reset just before and flash_fwd, flash_bwd_dq_sm90, flash_bwd_dkv_sm90
   must be > 0 just after (every other counter, the mma.sync pair's too,
   0); every loss and grad norm finite; prints the first loss,
   tokens/s, ms/step and peak memory, then one more step under
   ``torch.profiler`` for the device busy share and the top kernels; the
   bytes allocated once the params and AdamW state exist, before the
   first batch, held to the dry-run's estimate at one rank
   (``launch.dryrun.train_state_bytes``) up to the allocator's 512-byte
   rounding a tensor;
7. bert parity, then train-bert: bert-large at full width, 2 layers,
   float32, with ``lamb(warmup_poly(3.75e-3, 10, 7100))`` on ``cuda`` and
   on ``cpu`` (the tolerances of phase 5); then the published bert-large
   (24 layers, d 1024, 16 heads of 64, LayerNorm, GELU, non-causal, bf16,
   remat) with that recipe, clip 1.0, at seq 512 and batch 56 (the MLPerf
   step batch of 448 over the paper's 8 cards), 6 steps, through
   ``make_train_step`` and the ``Trainer``, with the checks, numbers and
   profile of phase 6;
8. olmo parity, then train-olmo: the same for olmo-1b (non-parametric
   LayerNorm, untied head, 16 heads of 128) with AdamW, then the
   published model (16 layers) through the training launcher at seq 2048,
   batch 4, 6 steps;
9. qwen3 parity, then serve-qwen3: qwen3-32b at full width, 2 layers,
   float32, served on ``cuda`` and on ``cpu`` (8 new tokens, the rules of
   phase 3); then qwen3-32b at its published width (d 5120, 64/8 heads of
   128, qk-norm, untied head, bf16) cut to 8 of its 64 layers, serving the
   requests of phase 4, with its checks, numbers and profile; then the
   same requests once more with the wrappers of flash_fwd (#1),
   flash_fwd_paged (#4) and flash_decode_paged (#8) watched, and each of
   the three held at the serve's call that did the most work (its
   layout, page list, positions and lane lengths, random q/K/V of its
   shapes) against its plain version, with the checks, times, bound and
   SDPA yardstick of phase 2, in a fresh Python process after the last
   phase (the profiler stops recording whole windows late in this one;
   one process for the three serves that hold their shapes), as
   ``at_shapes`` sub-entries;
10. olmoe parity, then serve-olmoe: olmoe-1b-7b at full width, 2 layers,
   float32, one packed batch (seq 256, batch 2) through the loss and its
   gradients on ``cuda`` and on ``cpu`` with every MoE call's routes
   watched: a route flip (a token whose top-k differs) only at a near-tie
   of the router (a gap of at most 1e-5 in the CPU's probabilities), its
   row then left out; the loss within 1e-4 relative, layer 0's attention
   and MoE gradients (router included) within 1e-3 scaled; then served on
   both (8 new tokens, the rules of phase 3 with the routes compared: a
   token divergence is allowed after a near-tie route flip too); then the
   published olmoe-1b-7b (16 layers, bf16) serving the requests of phase
   4, with its checks, numbers and profile (the MoE layers' share of the
   device time), and #1, #4 and #8 held at its calls as in phase 9;
11. phi3.5-moe parity, then serve-phi35moe: the same for
   phi3.5-moe-42b-a6.6b (16 experts of d_ff 6400, top-2, 32/8 heads of
   128), served at its full width cut to 8 of its 32 layers;
12. train-olmoe: olmoe-1b-7b at full width cut to 8 of its 16 layers
   (bf16, remat) with AdamW, warmup_cosine(3e-4, 20, 6), clip 1.0, seq
   2048, batch 4, 6 steps through ``make_train_step`` and the ``Trainer``,
   with the checks, numbers and profile of phase 6 and the cross-entropy
   and load-balancing loss of each step apart;
13. mamba2 parity, serve-mamba2, train-mamba2: mamba2-2.7b at full
   width, 2 layers, float32, on ``cuda`` and on ``cpu``: the loss of a
   packed batch within 1e-4 relative and every layer-0 gradient within
   1e-4 scaled, then served in dense slots (the family's default) with
   greedy tokens identical (a divergence only at a near-tie); then the
   published model (64 layers, bf16) in dense slots (4 of 2048) serving
   the requests of phase 4c with the 1024-token prompt at 1536, with the
   numbers of phase 4c, the profile of phase 4 (the SSM layers' share of
   the device time) and NO attention kernel launched; then trained
   through the training launcher as in phase 6 (seq 2048, batch 4, 6
   steps), again with no attention kernel launched;
14. hymba parity, serve-hymba, train-hymba: the same for hymba-1.5b (32
   layers, 25/5 heads of 64, window 1024, SSM heads beside attention; the
   parity's prompt of 1100 tokens and loss of 1280 reach past the
   window; its ``ssm_norm``, which the reference never reads, has a zero
   gradient on both sides), its serve launching flash_fwd and
   flash_decode and no paged kernel, its train flash_fwd,
   flash_bwd_dq_sm90 and flash_bwd_dkv_sm90; #1 and #7 held at serve-hymba's own calls in the
   fresh process of phase 9;
15. seamless parity, serve-seamless, train-seamless: seamless-m4t-medium
   at full width, 2 + 2 layers, float32, on ``cuda`` and on ``cpu``: the
   loss of one batch of frames and tokens within 1e-4 relative, every
   layer-0 gradient of both stacks and ``frontend_proj``'s within 1e-4
   scaled, greedy tokens of a prefill + 8 decode steps identical (a
   divergence only at a near-tie); then the published model (12 + 12
   layers, bf16) through the model-level loop (the engine and the
   launchers refuse the family, as the reference's cannot run it): 4
   sequences of 1024 frames and a 64-token prompt, 32 greedy decode
   steps, flash_fwd and flash_decode only, tokens identical to the plain
   path's (a divergence only at a bf16 near-tie), with tokens/s, prefill
   time, decode step p50, peak memory and a profiled pass; then trained
   6 steps (AdamW, warmup_cosine(1e-3, 2, 6)) on 4 rows of 1024 frames +
   1024 tokens through ``make_train_step`` and the ``Trainer``, with the
   checks, numbers and profile of phase 6 and a falling loss;
16. phi3v parity, serve-phi3v, train-phi3v: phi-3-vision-4.2b at full
   width, 2 layers, float32, on ``cuda`` and on ``cpu``: the loss of one
   batch of 576 patches + 64 tokens within 1e-4 relative, every layer-0
   gradient and ``frontend_proj``'s within 1e-4 scaled, greedy tokens of
   a prefill + 8 decode steps identical (a divergence only at a
   near-tie); then the published model (32 layers, bf16) through the
   model-level loop: 4 sequences of 576 patches and a 64-token prompt, 32
   greedy decode steps, flash_fwd and flash_decode only, every logit
   within ``PHI3V_LOGIT_SPACINGS`` bf16 spacings of the plain path's and
   each token within twice that of the plain maximum; then trained 6
   steps (AdamW) on 4 rows of 576 patches + 1472 tokens at full depth,
   with a falling loss. The paged serve of phase 4 (and those of phases
   9-11) print the engine's IO ledger: predicted HBM bytes, wall time and
   implied GB/s per step kind, against the card's 3.35 TB/s;
17. parity-tp, serve-tp2, serve-sp2 (``tp_serving_phase``): SPMD ranks
   (``repro_torch.distributed``, spawned through ``torch.multiprocessing``)
   sharing the one card over a gloo group, collectives staged through
   host memory (NCCL takes one card a rank): granite-3-2b at full width,
   2 layers, float32, at tp=2, sp=2 (allgather and ring) and (sp 2, tp 2)
   against the tp=1 engine on the card (greedy tokens identical,
   packed-prefill logits within 1e-4, each step kind's collective census
   exact on every rank); then granite-3-2b in bf16 at full width
   (``SERVE_TP_LAYERS``, 8 of 40 layers) serving serve's traffic at tp=2
   and at sp=2 (allgather) against the tp=1 serve: every rank's tokens
   identical, teacher-forced logits along tp=1's tokens within
   ``TP_LOGIT_SPACINGS`` bf16 spacings of tp=1's (a token parting only at a top-2 margin within twice that), #1 (at tp only),
   #4 and #8 launched on every rank, tok/s, TTFT p50 and each rank's peak
   memory of one cold serve.
18. parity-train-mesh, train-dp2tp2, pipeline-2 (``train_mesh_phase``):
   sharded training (``train.steps.make_sharded_train_step``) as four
   gloo ranks sharing the card in one spawn, collectives staged through
   host memory: granite-3-2b at full width, 2 layers, float32, 3 AdamW
   steps at data 2 x model 2 with ZeRO-1 against the
   single-rank step on the card (losses within ``TRAIN_MESH_RTOL``, every
   rank's census of every step ``expected_train_census``); granite-3-2b
   at 2 of 40 layers in bf16 at data 2 x model 2 with ZeRO-1, 4 steps of
   the launcher's recipe on its batches (seq 2048 x 4), losses within
   ``DP2TP2_LOSS_RTOL`` of the single-rank bf16 step's, ms a step, peak
   memory and launches a rank (#1-#3 on every rank; rank 0's counts are
   the ``train_dp2tp2`` path), the census; #1-#3 held to their plain
   versions at rank 0's layer (16 q / 4 kv heads, 2 rows) with phase 2's
   other shapes (``train_dp2tp2`` sub-entries); two 2-stage pipelines
   (``pipeline_apply``) on CUDA tensors against the sequential stack,
   forward and gradients.
19. parity-train-family, train-ep4, train-ssm-tp4 (``train_family_phase``):
   every family trained with a "model" axis above one, four gloo ranks
   sharing the card in one spawn: float32 at full width, 2 layers
   (seamless 2 + 2), 3 AdamW steps against the single-rank step on the
   card of olmoe-1b-7b at model 4 (16 experts a rank),
   phi-3-vision-4.2b at model 4 and seamless-m4t-medium at data 2 x
   model 2 (losses within ``TRAIN_MESH_RTOL``, MoE route flips only at
   near-ties: step 1 against the single rank, every later step against
   one forward of the mesh's own weights gathered onto rank 0; every
   rank's census of every step ``expected_train_census``);
   olmoe-1b-7b at 1 of 16 layers (expert-parallel, model 4) and
   mamba2-2.7b at 2 of 64 layers (cut by SSM head group, model 4) in bf16,
   4 steps of the launcher's recipe at seq 2048 x 4, losses within
   ``DP2TP2_LOSS_RTOL`` of the single-rank bf16 step's, ms a step, peak
   memory, collectives and launches a rank (rank 0's #1-#3 are the
   ``train_ep4`` path, held at its layer early, ``train_mesh_kernel_phase``).
20. levers (``levers_phase``): the chunked path's levers at hymba-1.5b's
   full width (4 of 32 layers, bf16, 4 x 2048 tokens, no segment ids):
   one forward + backward each with ``attn_impl="pallas"`` (#1-#3, the
   ``levers`` path), ``chunked``, ``chunked`` + ``attn_pv_bf16`` and
   ``chunked`` + ``banded_window`` + ``attn_pv_bf16``, each chunked run's
   loss and layer-0 gradients within 2e-2 of the pallas run's (scaled by
   the largest of layer 0's gradients; each leaf by its own max, and
   every run against a float32 run of the same weights, printed), with
   ms, peak memory and score bytes a layer; then float32 at 2 layers,
   banded within 1e-4 of chunked.
21. tuning (``tuning_phase``, run last, after every profiled phase): the
   tuner (``kernels/tuning.py``) with autotuning on and a fresh cache
   (``build/autotune.json``): the attention tiles at granite-3-2b's layer
   (32 q / 8 kv heads of 64, forward, and forward + backward under
   ``|bwd``), at train-dp2tp2's rank layer (16 / 4 heads, ``shards=2``,
   backward) and at olmo-1b's (16 / 16 heads of 128, forward), each at a
   bucket of 2048 rows, causal, bf16; the contiguous decode at 2048 slots
   and the paged decode at page 16 over 2048; the sp strategy at sp 2.
   Every timed candidate's ms and spread, the winner and its source are
   printed (granite's forward also tuned into a second fresh cache); a
   second resolution of each must come from the cache; every winner is
   held against its plain version (|o| 2e-2, gradients 2e-2 of their
   max); the calibration of the IO model's bytes against the clock is
   printed beside 3.35 TB/s; then ``python -m repro_torch.kernels.tuning
   --smoke --device cuda`` runs twice, the second time with
   ``--expect-hit``, and both must exit 0. Autotuning is off again after
   the phase, so no path's tiles move.
22. kvseq (``kvseq_phase``, after levers; its kernels,
   ``kvseq_kernel_phase``, right after phi-3-vision's): the
   sequence-sharded decode (``train.steps.make_sharded_serve_steps``: the
   KV capacity, or the page pool's pages, cut over "model", each rank's
   #7 / #8 split partials merged across ranks) as gloo ranks sharing the
   card, one spawn of 2 ranks and one of 4. #7 and #8 at serve-kvseq2's
   rank slices (32 q / 8 kv heads of 64, 16384 of 32768 slots or 2048 of
   4096 pages of 16, one lane past the slice boundary and one short of
   it), each rank's launch against its plain partials and both ranks
   merged within 2e-2, rank 0's launch timed beside its plain version,
   its bound over the keys in its reach and SDPA over them (the
   ``serve_kvseq2`` / ``serve_kvseq2_paged`` entries of the two kernels'
   ``at_shapes``); parity-kvseq: granite-3-2b at full width, 2 layers,
   float32, slots and pages at (data 1, model 2) and (data 2, model 2)
   against the single rank's ``Model.decode_step`` on the card (greedy
   tokens identical, logits within 1e-4, every step's census
   ``expected_kv_seq_decode_census`` on every rank); serve-kvseq2 and
   serve-kvseq2-paged: granite-3-2b in bf16 at full width (8 of 40 layers
   each; serve-kvseq2 ran all 40 before), data 1 x model 2, 2 lanes of 16376-token prompts at
   capacity 32768, 16 decode steps teacher-forced along the single rank's
   greedy tokens
   (logits within ``TP_LOGIT_SPACINGS`` bf16 spacings, an argmax parting
   only at a top-2 margin within twice that), #1 and #7 / #8 launched on
   both ranks, decode tok/s, per-rank peak memory and each rank's
   decode-state bytes equal to ``launch.dryrun.decode_state_bytes``.

``--ab PARENT_CHECKOUT`` runs only an A/B against another checkout (e.g.
``git archive`` of the parent commit): first both checkouts' kernel
sources compiled with ``-Xptxas -v`` to cubins, printing every parent
kernel's registers, stack and spills on both sides and whether its SASS
(``cuobjdump -sass``) is identical; then this script's
``train_kernel_phase`` (first, so that both sides time the training
kernels from the same process state), ``kernel_phase``,
``paged_grad_ab`` (the paged dq and dkv kernels and the whole paged
backward), ``serve_phase``, ``dense_serve_phase`` and ``train_phase``
(without the profiled passes) on that checkout's package
and on this one's (one measurement for both sides; a decode of a checkout
without the fused launch is timed as its partials kernel and the torch
merge, ``whole_decode``), each in a fresh
process, in the order parent, change, change, parent on the same card,
then each side's per-run numbers (record in
``build/chip_smoke_ab.json``).

Prints one JSON line of kernel results (``launches`` summed over the
main paths' runs, per path under ``launches_by_path``), then as its last
line
``{"ok": true, "device": {...}}``. Exits non-zero on any failure, without
a CUDA device, or without the repository beside it. A full record is
written to ``build/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
# H100 SXM rates (NVIDIA data sheet), set from repro_torch.core.io_model
# once the package is on the path (``use_io_model``): HBM bytes/s, dense
# bf16 tensor-core FLOP/s, fp32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = BF16_FLOPS_PER_S = FP32_FLOPS_PER_S = None
L2_BYTES = 50e6


def use_io_model() -> None:
    """The card's rates from the port's IO model: one source for every
    bound this script and the serving engine's IO ledger compute."""
    global HBM_BYTES_PER_S, BF16_FLOPS_PER_S, FP32_FLOPS_PER_S
    from repro_torch.core import io_model
    HBM_BYTES_PER_S = io_model.H100_HBM_BW
    BF16_FLOPS_PER_S = io_model.H100_BF16_FLOPS
    FP32_FLOPS_PER_S = io_model.H100_FP32_FLOPS


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def time_ms(torch, fns, warmup=3, iters=20) -> float:
    """Time of one call on the card's clock (CUDA events around ``iters``
    calls), cycling over ``fns`` — one closure per rotated input copy. The
    host's gaps between launches count: a call whose wrapper takes longer
    on the host than its kernels on the card reads its host time."""
    for i in range(warmup):
        fns[i % len(fns)]()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fns, warmup=3, iters=20) -> float:
    """Device time of one call: every kernel the ``iters`` calls launch
    (cycling over ``fns``), summed by ``torch.profiler``, over ``iters``.
    Unlike ``time_ms`` it leaves out the host's gaps between launches,
    which set the CUDA-event time of a call that takes less device time
    than its wrapper takes host time. On the card's machine a profiled
    window now and then records no device event at all, or only some of
    the kernels it ran (seen early and late in a process, now and then
    several windows in a row; ``serve_shape_records_apart`` says what
    happens late in this script's process). Every call launches the same
    kernels, so
    a window is kept only if it counts each of its kernels a multiple of
    ``iters`` times; any other is profiled again after a pause, up to ten
    windows in all."""
    from torch.profiler import ProfilerActivity, profile
    for i in range(warmup):
        fns[i % len(fns)]()
    torch.cuda.synchronize()
    for attempt in range(10):
        if attempt:
            print(f"[profile] window {attempt} recorded no device time or "
                  f"only part of its kernels: profiling again", flush=True)
            time.sleep(0.5)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fns[i % len(fns)]()
            torch.cuda.synchronize()
        kernels = device_kernels(prof)
        us = sum(_device_us(e) for e in kernels)
        if us > 0 and all(e.count % iters == 0 for e in kernels):
            return us / 1e3 / iters
    raise SmokeFailure("torch.profiler recorded no whole window of device "
                       "time in ten")


def timed(torch, fns) -> tuple[float, float]:
    """(device_ms, time_ms) of the same calls."""
    return device_ms(torch, fns), time_ms(torch, fns)


def copies_for(nbytes: int) -> int:
    """Input copies to rotate so one pass exceeds twice the L2 cache."""
    return max(1, min(16, math.ceil(2 * L2_BYTES / max(nbytes, 1))))


def bound(nbytes: float, flops: float, dtype_peak: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / dtype_peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def release(torch) -> None:
    """Free what the last phase left: its objects (some sit in reference
    cycles) and the allocator's cached blocks, so that the next phase's
    peak memory is its own."""
    gc.collect()
    torch.cuda.empty_cache()


def rel_err(a, b) -> float:
    """max |a - b| / max(1, |b|) over finite entries (m and l)."""
    a, b = a.float(), b.float()
    return float(((a - b).abs() / b.abs().clamp_min(1.0)).max())


# ---------------------------------------------------------------------------
# phase 2: kernels at the main path's shapes
# ---------------------------------------------------------------------------

def kernel_phase(torch, seed: int) -> list[dict]:
    from repro_torch.core import masks as M
    from repro_torch.kernels import tuning

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(seed)
    hq, hkv, d, ps = 32, 8, 64, 16
    scale = d ** -0.5
    results = []

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev, dtype=bf16)

    # -- flash_fwd: packed zero-offset prefill of several documents --------
    lengths = [700, 500, 400, 300, 148]
    S = sum(lengths)
    seg = torch.cat([torch.full((n,), i, dtype=torch.int32)
                     for i, n in enumerate(lengths)])[None].to(dev)
    bq, bk = tuning.fwd_tiles(d)
    spec = M.MaskSpec(causal=True, q_segment_ids=seg, kv_segment_ids=seg)
    layout = M.compile_block_layout(spec, S, S, bq, bk).as_array(dev)
    call = dict(scale=scale, causal=True, window=None, q_offset=0,
                block_q=bq, block_k=bk, q_segment_ids=seg, kv_segment_ids=seg)
    results.append(packed_prefill_record(
        torch, gen, (randn(1, hq, S, d), randn(1, hkv, S, d),
                     randn(1, hkv, S, d), None, layout), call,
        f"packed prefill b=1 S={S} docs={lengths}", mma=True))

    # -- flash_fwd_paged: chunks against paged prefixes ---------------------
    spans, chunks = [1536, 600], [192, 64]
    sq = sum(chunks)
    T = sum(-(-s // ps) for s in spans) + 2          # two dead slots
    num_pages = 400
    pages = torch.randperm(num_pages, generator=gen, device=dev).int()
    page_list = torch.full((1, T), -1, dtype=torch.int32, device=dev)
    kv_seg = torch.full((1, T * ps), M.SEG_PAD_KV, dtype=torch.int32, device=dev)
    kv_pos = torch.full((1, T * ps), M.POS_PAD, dtype=torch.int32, device=dev)
    q_seg = torch.empty((1, sq), dtype=torch.int32, device=dev)
    q_pos = torch.empty((1, sq), dtype=torch.int32, device=dev)
    slot = row = 0
    for i, (span, n) in enumerate(zip(spans, chunks)):
        np_ = -(-span // ps)
        page_list[0, slot:slot + np_] = pages[slot:slot + np_]
        kv_seg[0, slot * ps:slot * ps + span] = i
        kv_pos[0, slot * ps:slot * ps + span] = torch.arange(span, device=dev)
        q_seg[0, row:row + n] = i
        q_pos[0, row:row + n] = torch.arange(span - n, span, device=dev)
        slot, row = slot + np_, row + n
    pspec = M.MaskSpec(causal=True, q_segment_ids=q_seg, kv_segment_ids=kv_seg,
                       q_positions=q_pos, kv_positions=kv_pos)
    play = M.compile_block_layout(pspec, sq, T * ps, bq, ps).as_array(dev)
    play = M.paged_prefill_block_layout(play, page_list)
    pcall = dict(scale=scale, causal=True, window=None, block_q=bq,
                 q_segment_ids=q_seg, kv_segment_ids=kv_seg,
                 q_positions=q_pos, kv_positions=kv_pos)
    results.append(paged_prefill_record(
        torch, gen, (randn(1, hq, sq, d), randn(hkv, num_pages, ps, d),
                     randn(hkv, num_pages, ps, d), page_list, play), pcall,
        f"chunks {chunks} against paged prefixes {spans}, page {ps}",
        mma=True))

    # -- flash_decode_paged: batch 8 over ~1k-token contexts, 1152-slot page
    # tables with unallocated tails
    kv_len = torch.tensor([900, 1100, 1000, 1024, 950, 1050, 980, 1070],
                          dtype=torch.int32, device=dev)
    b, T = len(kv_len), 1152 // ps
    table = torch.randperm(b * T, generator=gen, device=dev).int()
    table = table.reshape(b, T).clone()
    for i, n in enumerate(kv_len.tolist()):
        table[i, -(-(n + 1) // ps):] = -1           # unallocated tail
    dcall = dict(scale=scale, num_splits=tuning.resolve_paged_decode_splits(T),
                 window=None)
    results.append(paged_decode_record(
        torch, gen, (randn(b, hq, 1, d), randn(hkv, b * T, ps, d),
                     randn(hkv, b * T, ps, d), table, kv_len,
                     M.paged_block_layout(kv_len, table, ps)), dcall))
    results.append(contiguous_decode_record(torch, gen, randn, hq, hkv, d))
    # flash_fwd.cu's mma.sync body at the same two shapes: no main path
    # launches it at these head dims
    results += [mma_body_record(results[0], "flash_fwd"),
                mma_body_record(results[1], "flash_fwd_paged")]
    return results


def fresh(torch, gen, t):
    """A random tensor on the card of ``t``'s shape and dtype."""
    return torch.randn(t.shape, generator=gen, device="cuda", dtype=t.dtype)


def copies(torch, gen, tensors, nbytes_: int) -> list[tuple]:
    """``tensors`` and enough random copies of them that one pass over all
    exceeds twice the L2 cache (``nbytes_`` per set)."""
    return [tuple(tensors)] + [tuple(fresh(torch, gen, t) for t in tensors)
                               for _ in range(copies_for(nbytes_) - 1)]


def scored_pairs(fa, q, sk, kv_mask, layout, call, block_k):
    """(b or 1, 1, sq, sk) bool, or (sq, sk): the (q, k) pairs the kernel
    scores, as its plain version masks them."""
    return fa._allowed(
        layout, kv_mask, b=q.shape[0], sq=q.shape[2], sk=sk, dev=q.device,
        causal=call["causal"], window=call["window"],
        q_offset=call.get("q_offset", 0),
        kv_valid_len=call.get("kv_valid_len"), block_q=call["block_q"],
        block_k=block_k, q_segment_ids=call.get("q_segment_ids"),
        kv_segment_ids=call.get("kv_segment_ids"),
        q_positions=call.get("q_positions"),
        kv_positions=call.get("kv_positions"))


def _meta(call) -> list:
    return [call.get(n) for n in ("q_segment_ids", "kv_segment_ids",
                                  "q_positions", "kv_positions")]


def _fwd_mode(torch, b, hq, nq, tiles) -> dict:
    """The sm90 forward's CTA mode at a call's grid (``tuning``'s rule on
    this card)."""
    from repro_torch.kernels import tuning
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {"rows": tuning.sm90_fwd_rows(b, hq, nq, sms),
            "splits": tuning.sm90_fwd_splits(b, hq, nq, tiles, sms)}


def _mma_fields(torch, rec, plain, run, sets) -> None:
    """flash_fwd.cu's mma.sync body (``run`` forces it with ``_mma_body``)
    held against the same plain version and timed on the same inputs
    ``sets``, into ``rec``'s ``mma_*`` fields."""
    out = run(sets[0])
    torch.cuda.synchronize()
    o_err = float((out[0].float() - plain[0].float()).abs().max())
    m_err, l_err = rel_err(out[1], plain[1]), rel_err(out[2], plain[2])
    check(o_err <= 2e-2 and m_err <= 1e-2 and l_err <= 1e-2,
          f"{rec['name']}'s mma.sync body: |o - plain| {o_err}, m/l "
          f"{m_err}/{l_err}")
    rec.update(mma_max_abs_err=o_err, mma_m_rel_err=m_err,
               mma_l_rel_err=l_err,
               mma_ms=device_ms(torch, [lambda a=a: run(a) for a in sets]))
    print(f"[kernel] {rec['name']}: the mma.sync body {rec['mma_ms']:.4f} ms "
          f"on the same inputs (sm90 {rec['ms']:.4f}: "
          f"{rec['ms'] / rec['mma_ms']:.3f}x), max|o-plain| {o_err:.3g}",
          flush=True)


def mma_body_record(rec: dict, name: str) -> dict:
    """The record of flash_fwd.cu's mma.sync body at the shape of the sm90
    record ``rec`` (its ``mma_*`` fields): no main path launches it."""
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_fwd.cu",
            "replaces": rec["replaces"], "launches": None,
            "max_abs_err": rec["mma_max_abs_err"],
            "m_rel_err": rec["mma_m_rel_err"],
            "l_rel_err": rec["mma_l_rel_err"], "ms": rec["mma_ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "library": rec["library"], "shape": rec["shape"],
            "call_ms": None, **MMA_FWD_NOTE}


def packed_prefill_record(torch, gen, args, call, shape, mma=False) -> dict:
    """flash_fwd_sm90 (#1's sm90 body) on ``args`` = (q, k, v, kv_mask,
    layout) under ``call`` against its plain version; timed over random
    copies of q, k and v; SDPA with the pairs the kernel scores as a
    boolean mask is the library yardstick. With ``mma`` the mma.sync body
    beside it (``_mma_fields``)."""
    from repro_torch.kernels import flash_attention as fa

    sdpa = torch.nn.functional.scaled_dot_product_attention
    q, k, v, kv_mask, layout = args
    b, hq, sq, d = q.shape
    sk = k.shape[2]
    out = fa.flash_attention_forward(*args, **call)
    torch.cuda.synchronize()
    plain = fa.flash_attention_forward_plain(*args, **call)
    sets = copies(torch, gen, (q, k, v), nbytes(q, k, v))
    ms, call_ms = timed(torch, [lambda a=a: fa.flash_attention_forward(
        *a, kv_mask, layout, **call) for a in sets])
    plain_ms = device_ms(torch, [lambda: fa.flash_attention_forward_plain(
        *args, **call)], warmup=1, iters=3)
    mask = scored_pairs(fa, q, sk, kv_mask, layout, call, call["block_k"])
    lib_ms = device_ms(torch, [lambda a=a: sdpa(
        *a, attn_mask=mask, scale=call["scale"], enable_gqa=True)
        for a in sets])
    pairs = int(mask.expand(b, 1, sq, sk).sum()) * hq
    b_ms, b_by = bound(nbytes(q, k, v, *out, kv_mask, layout, *_meta(call)),
                       4.0 * d * pairs, BF16_FLOPS_PER_S)
    rec = _kernel_record(
        "flash_fwd_sm90", "src/repro_torch/kernels/csrc/flash_fwd_sm90.cu",
        "src/repro/kernels/flash_attention.py:325", out, plain, ms, plain_ms,
        b_ms, b_by, lib_ms, call_ms=call_ms, shape=shape,
        library="SDPA, bool mask")
    rec["cta_mode"] = _fwd_mode(torch, b, hq, sq // call["block_q"],
                                -(-sk // 64))
    if mma:
        _mma_fields(torch, rec, plain, lambda a: fa.flash_attention_forward(
            *a, kv_mask, layout, **call, _mma_body=True), sets)
    return rec


def paged_prefill_record(torch, gen, args, call, shape, mma=False) -> dict:
    """flash_fwd_paged_sm90 (#4's sm90 body) on ``args`` = (q, k_pool,
    v_pool, page_list, layout) under ``call`` against its plain version;
    timed over random copies of q and the pools; SDPA on K/V gathered
    beforehand, with the pairs the kernel scores as a boolean mask, is the
    library yardstick. With ``mma`` the mma.sync body beside it."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import gather_pages

    sdpa = torch.nn.functional.scaled_dot_product_attention
    q, k_pool, v_pool, page_list, layout = args
    b, hq, sq, d = q.shape
    hkv, _, ps, _ = k_pool.shape
    sk = page_list.shape[1] * ps
    out = fa.flash_prefill_paged_forward(*args, **call)
    torch.cuda.synchronize()
    plain = fa.flash_prefill_paged_forward_plain(*args, **call)
    live = int((page_list >= 0).sum())
    kv_bytes = 2 * live * hkv * ps * d * k_pool.element_size()
    sets = copies(torch, gen, (q, k_pool, v_pool), nbytes(q) + kv_bytes)
    ms, call_ms = timed(torch, [lambda a=a: fa.flash_prefill_paged_forward(
        *a, page_list, layout, **call) for a in sets])
    plain_ms = device_ms(torch, [lambda: fa.flash_prefill_paged_forward_plain(
        *args, **call)], warmup=1, iters=3)
    mask = scored_pairs(fa, q, sk, None, layout, call, ps)
    pairs = int(mask.expand(b, 1, sq, sk).sum()) * hq
    b_ms, b_by = bound(nbytes(q, *out, layout, page_list, *_meta(call))
                       + kv_bytes, 4.0 * d * pairs, BF16_FLOPS_PER_S)
    gathered = [(a[0], gather_pages(a[1], page_list),
                 gather_pages(a[2], page_list))
                for a in sets]                       # the gather is not timed
    lib_ms = device_ms(torch, [lambda a=a: sdpa(
        *a, attn_mask=mask, scale=call["scale"], enable_gqa=True)
        for a in gathered])
    del gathered
    rec = _kernel_record(
        "flash_fwd_paged_sm90",
        "src/repro_torch/kernels/csrc/flash_fwd_sm90.cu",
        "src/repro/kernels/flash_attention.py:765", out, plain, ms, plain_ms,
        b_ms, b_by, lib_ms, call_ms=call_ms, shape=shape,
        library="SDPA on pre-gathered K/V, bool mask")
    rec["cta_mode"] = _fwd_mode(torch, b, hq, sq // call["block_q"],
                                -(-sk // 64))
    if mma:
        _mma_fields(torch, rec, plain,
                    lambda a: fa.flash_prefill_paged_forward(
                        *a, page_list, layout, **call, _mma_body=True), sets)
    return rec


def paged_decode_record(torch, gen, args, call) -> dict:
    """flash_decode_paged (#8), the whole decode (one launch that writes the
    split partials and merges them, its layout lowered beforehand), on
    ``args`` = (q, k_pool, v_pool, page_table, kv_len, layout) under
    ``call`` (no window) against the plain partials and their torch merge;
    timed over random copies of q and the pools; SDPA on K/V gathered
    beforehand is the library yardstick."""
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels.ref import gather_pages

    sdpa = torch.nn.functional.scaled_dot_product_attention
    qd, k_pool, v_pool, table, kv_len, dlay = args
    b, hq, _, d = qd.shape
    hkv, _, ps, _ = k_pool.shape
    T = table.shape[1]
    check(call["window"] is None, "paged_decode_record takes no window")
    whole = whole_decode(fd, paged=True)
    o, parts = whole(*args, **call)
    torch.cuda.synchronize()
    pparts = fd.flash_decode_paged_partials_plain(*args, **call)
    out = (o, parts[1], parts[2])
    plain = (fd._merge_split_partials(*pparts, qd.dtype), pparts[1], pparts[2])
    o_p_err = check_partials("flash_decode_paged", parts, pparts)
    rows = sum(-(-n // ps) * ps for n in kv_len.tolist())
    kv_bytes = 2 * rows * hkv * d * k_pool.element_size()
    sets = copies(torch, gen, (qd, k_pool, v_pool), kv_bytes)
    ms, call_ms = timed(torch, [lambda a=a: whole(
        *a, table, kv_len, dlay, **call) for a in sets])
    plain_ms = device_ms(torch, [lambda: fd._merge_split_partials(
        *fd.flash_decode_paged_partials_plain(*args, **call), qd.dtype)],
        warmup=1, iters=3)
    pairs = int(kv_len.sum()) * hq
    b_ms, b_by = bound(nbytes(qd, o, *parts, table, kv_len, dlay) + kv_bytes,
                       4.0 * d * pairs, BF16_FLOPS_PER_S)
    dmask = (torch.arange(T * ps, device=qd.device)[None, :]
             < kv_len[:, None])[:, None, None, :]  # (b, 1, 1, T*ps) bool
    gathered = [(a[0], gather_pages(a[1], table), gather_pages(a[2], table))
                for a in sets]                       # the gather is not timed
    lib_ms = device_ms(torch, [lambda a=a: sdpa(
        *a, attn_mask=dmask, scale=call["scale"], enable_gqa=True)
        for a in gathered])
    del gathered
    rec = _kernel_record(
        "flash_decode_paged", "src/repro_torch/kernels/csrc/flash_decode.cu",
        "src/repro/kernels/flash_decode.py:329", out, plain, ms, plain_ms,
        b_ms, b_by, lib_ms, call_ms=call_ms,
        shape=f"whole decode b={b} hq={hq} hkv={hkv} d={d} kv_len "
              f"{kv_len.tolist()} page {ps} table {T} pages splits "
              f"{call['num_splits']}",
        library="SDPA on pre-gathered K/V, bool mask")
    rec["o_p_err"] = o_p_err
    return rec


def contiguous_decode_record(torch, gen, randn, hq, hkv, d) -> dict:
    """flash_decode (#7) at the dense serve's decode shape: batch 8 over a
    2048-slot cache, kv_len 900-1100; also checked with a window and with
    a kv_mask. Timed on the plain case; SDPA over the contiguous cache with
    the validity mask as a boolean mask and GQA is the library yardstick."""
    from repro_torch.core import masks as M
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import tuning

    dev = torch.device("cuda")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, cap = 8, 2048
    scale = d ** -0.5
    kv_len = torch.tensor([900, 1100, 1000, 1024, 950, 1050, 980, 1070],
                          dtype=torch.int32, device=dev)
    bk, splits = tuning.resolve_decode_geometry(cap, None, None)
    qd, kc, vc = randn(b, hq, 1, d), randn(b, hkv, cap, d), randn(b, hkv, cap, d)
    masked = torch.rand(b, cap, generator=gen, device=dev) > 0.25
    whole = whole_decode(fd, paged=False)
    errs = {}
    for case, window, kvm in (("plain", None, None), ("window 256", 256, None),
                              ("kv_mask", None, masked)):
        valid = M.decode_kv_valid(kv_len, cap, window=window, kv_mask=kvm)
        lay = M.kv_block_layout(valid, bk)
        call = dict(scale=scale, block_k=bk, num_splits=splits, window=window,
                    kv_mask=kvm)
        o, parts = whole(qd, kc, vc, kv_len, lay, **call)
        torch.cuda.synchronize()
        pparts = fd.flash_decode_partials_plain(qd, kc, vc, kv_len, lay, **call)
        out = (o, *parts[1:])
        plain = (fd._merge_split_partials(*pparts, torch.bfloat16), *pparts[1:])
        o_err = float((out[0].float() - plain[0].float()).abs().max())
        errs[case] = o_err
        check(o_err <= 2e-2, f"flash_decode ({case}): max |o - plain| {o_err}")
        check(rel_err(out[1], plain[1]) <= 1e-2 and rel_err(out[2], plain[2])
              <= 1e-2, f"flash_decode ({case}): m/l differ from the plain "
                       f"version")
        o_p_err = check_partials(f"flash_decode ({case})", parts, pparts)
        if case == "plain":
            first = (out, plain, lay, call, valid, parts, o_p_err)
    out, plain, lay, call, valid, parts, o_p_err = first
    rec = contiguous_decode_timed(
        torch, gen, (qd, kc, vc, kv_len, lay), call, valid, out, plain, parts,
        f"whole contiguous decode b={b} capacity {cap} kv_len "
        f"{kv_len.tolist()} block_k {bk} splits {splits}")
    rec["case_errs"] = errs
    rec["o_p_err"] = o_p_err
    return rec


def contiguous_decode_timed(torch, gen, args, call, valid, out, plain, parts,
                            shape) -> dict:
    """flash_decode (#7)'s record on ``args`` = (q, k_cache, v_cache,
    kv_len, layout) under ``call``, given its checked output: the whole
    decode timed over random copies of q and the cache, the plain
    partials and torch merge, the bound over the ``valid`` keys (window
    and mask applied), and SDPA over the contiguous cache with ``valid``
    as a boolean mask (GQA) as the library yardstick."""
    from repro_torch.kernels import flash_decode as fd

    sdpa = torch.nn.functional.scaled_dot_product_attention
    whole = whole_decode(fd, paged=False)
    qd, kc, vc, kv_len, lay = args
    b, hq, _, d = qd.shape
    hkv = kc.shape[1]
    rows = int(valid.sum())                  # the keys this data needs
    kv_bytes = 2 * rows * hkv * d * kc.element_size()
    sets = copies(torch, gen, (qd, kc, vc), nbytes(kc, vc))
    ms, call_ms = timed(torch, [lambda a=a: whole(
        *a, kv_len, lay, **call) for a in sets])
    plain_ms = device_ms(torch, [lambda: fd._merge_split_partials(
        *fd.flash_decode_partials_plain(*args, **call), qd.dtype)],
        warmup=1, iters=3)
    b_ms, b_by = bound(nbytes(qd, out[0], *parts, kv_len, lay) + kv_bytes,
                       4.0 * d * rows * hq, BF16_FLOPS_PER_S)
    mask = valid[:, None, None, :]                # (b, 1, 1, cap) bool
    lib_ms = device_ms(torch, [lambda a=a: sdpa(
        *a, attn_mask=mask, scale=call["scale"], enable_gqa=True)
        for a in sets])
    return _kernel_record(
        "flash_decode", "src/repro_torch/kernels/csrc/flash_decode.cu",
        "src/repro/kernels/flash_decode.py:169", out, plain, ms, plain_ms,
        b_ms, b_by, lib_ms, call_ms=call_ms, shape=shape,
        library="SDPA on the contiguous cache, bool mask, GQA")


def contiguous_decode_record_at(torch, gen, args, call) -> dict:
    """flash_decode (#7) at a captured call, ``args`` = (q, k_cache,
    v_cache, kv_len, layout) and ``call`` as the serve gave them (its
    window and slot mask), against the plain partials and torch merge
    (``contiguous_decode_timed``)."""
    from repro_torch.core import masks as M
    from repro_torch.kernels import flash_decode as fd

    qd, kc, vc, kv_len, lay = args
    b, hq, _, d = qd.shape
    cap = kc.shape[2]
    o, parts = whole_decode(fd, paged=False)(*args, **call)
    torch.cuda.synchronize()
    pparts = fd.flash_decode_partials_plain(*args, **call)
    out = (o, *parts[1:])
    plain = (fd._merge_split_partials(*pparts, qd.dtype), *pparts[1:])
    o_p_err = check_partials("flash_decode", parts, pparts)
    valid = M.decode_kv_valid(kv_len, cap, window=call["window"],
                              kv_mask=call.get("kv_mask"))
    rec = contiguous_decode_timed(
        torch, gen, args, call, valid, out, plain, parts,
        f"whole contiguous decode b={b} hq={hq} hkv={kc.shape[1]} d={d} "
        f"capacity {cap} kv_len {kv_len.tolist()} window {call['window']} "
        f"block_k {call['block_k']} splits {call['num_splits']}, "
        f"{int(valid.sum())} keys in reach")
    rec["o_p_err"] = o_p_err
    return rec


def whole_decode(fd, paged: bool):
    """The whole decode for a lowered layout, returning (out, (o_p, m_p,
    l_p)): the package's one fused launch, or, in a checkout that predates
    it (a ``--ab`` parent), its partials kernel followed by the torch
    merge, so both sides of an A/B compute the same function."""
    fused = getattr(fd, "flash_decode_paged_from_layout" if paged
                    else "flash_decode_from_layout", None)
    if fused is not None:
        return fused
    partials = (fd.flash_decode_paged_partials if paged
                else fd.flash_decode_partials)

    def call(q, *args, **kw):
        parts = partials(q, *args, **kw)
        return fd._merge_split_partials(*parts, q.dtype), parts
    return call


def check_partials(name, parts, plain_parts) -> float:
    """The split accumulators o_p against the plain version, each split's
    error scaled by its plain l: the error of the split's own normalized
    output, held to the bf16 output tolerance, 2e-2 (the bf16 kernel
    rounds P to bf16 for its P V product, as flash_fwd does; m and l are
    checked with the output)."""
    scale = plain_parts[2].float().clamp_min(1.0)[..., None]
    err = float(((parts[0].float() - plain_parts[0].float()).abs() / scale).max())
    check(err <= 2e-2, f"{name}: split partials o_p differ from the plain "
                       f"version (max |o_p - plain| / max(1, l) = {err})")
    return err


def _kernel_record(name, source, replaces, out, plain, ms, plain_ms, b_ms,
                   b_by, lib_ms, shape, library=None, call_ms=None):
    """One kernel's line: errors against the plain version, ``ms`` its
    device time per call (``device_ms``), ``call_ms`` its CUDA-event time
    per call (``time_ms``)."""
    o_err = float((out[0].float() - plain[0].float()).abs().max())
    m_err, l_err = rel_err(out[1], plain[1]), rel_err(out[2], plain[2])
    rec = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": None, "max_abs_err": o_err,
           "m_rel_err": m_err, "l_rel_err": l_err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": lib_ms, "library": library, "shape": shape,
           "call_ms": call_ms}
    print(f"[kernel] {name}: {shape}: max|o-plain| {o_err:.3g} "
          f"m rel {m_err:.3g} l rel {l_err:.3g}; {ms:.4f} ms on the card, "
          f"{call_ms:.4f} ms a call "
          f"(plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms by {b_by}"
          + (f", {library} {lib_ms:.4f} ms" if lib_ms is not None else "")
          + ")", flush=True)
    check(o_err <= 2e-2, f"{name}: max |o - plain| {o_err} > 2e-2")
    check(m_err <= 1e-2 and l_err <= 1e-2,
          f"{name}: m/l relative error {m_err}/{l_err} > 1e-2")
    return rec


# ---------------------------------------------------------------------------
# phase 2b: the training path's kernels at the training shape
# ---------------------------------------------------------------------------

def scaled_err(got, want) -> float:
    """max |got - want| / max |want| (gradients)."""
    want = want.float()
    return float((got.float() - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


# score elements (b x heads x S x S, float32) of one call of a plain
# version in ``fwd_bwd_case``: the largest case that runs whole,
# blocksparse_4k's (4, 12, 4096, 4096); larger ones run by groups of heads
PLAIN_SCORES = 4 * 12 * 4096 * 4096


def plain_by_heads(torch, plain, heads, rest, call):
    """``plain(*heads, *rest, **call)`` over as many KV heads a call as keep
    its float32 scores within ``PLAIN_SCORES`` elements: ``heads`` are (b,
    h, S, ...) with h = hq or hkv (q before k), ``rest`` is not per head;
    the outputs are concatenated on the head axis. One call where all heads
    fit, so the result is the whole call's at every shape."""
    b, hq, S = heads[0].shape[:3]
    hkv = heads[1].shape[1]
    r = hq // hkv
    g = max(1, min(hkv, PLAIN_SCORES // (b * r * S * S)))
    if g == hkv:
        return plain(*heads, *rest, **call)

    def part(t, h0):
        n = t.shape[1] // hkv            # q heads a KV head, or 1
        return t[:, h0 * n:(h0 + g) * n]

    outs = [plain(*(part(t, h0) for t in heads), *rest, **call)
            for h0 in range(0, hkv, g)]
    return tuple(torch.cat(parts, dim=1) for parts in zip(*outs))


def fwd_bwd_case(torch, gen, b, hq, hkv, S, d, causal, seg,
                 window=None, sparse=None, kv_mask=None, mma=False) -> dict:
    """The forward kernel against its plain version, then dq / dkv from the
    kernel forward's (o, m, l) against the plain backward from the same
    residuals, two calls of the pair bit-identical, at one training
    layer's attention shape in bf16 (packed documents ``seg`` or None, a
    causal sliding ``window`` if given, an Alg. 5 ``sparse`` pattern at
    the kernels' tiles and a ``kv_mask`` if given); each kernel timed
    (device time) beside its bound (over the pairs the kernels score), its
    plain time and SDPA's (with those pairs as a boolean mask, window
    included: SDPA has no window argument). The plain versions run as
    ``plain_by_heads`` (at most ``PLAIN_SCORES`` score elements a call).
    With ``mma`` (``MMA_SHAPES``) the mma.sync bodies of the forward and
    of the pair are held against the same plain versions and timed beside
    the sm90 ones. Returns the numbers, and the inputs and residuals for
    further checks."""
    from repro_torch.core import masks as M
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import tuning

    dev = torch.device("cuda")
    scale = d ** -0.5
    bq, bk = tuning.bwd_tiles(d)
    spec = M.MaskSpec(causal=causal, window=window, q_segment_ids=seg,
                      kv_segment_ids=seg, kv_mask=kv_mask,
                      sparse_layout=sparse)
    layout = M.compile_block_layout(spec, S, S, bq, bk).as_array(dev)
    call = dict(scale=scale, causal=causal, window=window, q_offset=0,
                block_q=bq, block_k=bk, q_segment_ids=seg, kv_segment_ids=seg)
    shape = (f"layer b={b} hq={hq} hkv={hkv} S={S} d={d}, "
             f"{'causal' if causal else 'non-causal'}"
             + (f", window {window}" if window is not None else "")
             + (f", {int(seg.max(dim=1).values.sum()) + b} documents"
                if seg is not None else "")
             + (", kv_mask" if kv_mask is not None else ""))

    def randn(*shp):
        return torch.randn(*shp, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    q, k, v, do = randn(b, hq, S, d), randn(b, hkv, S, d), randn(b, hkv, S, d), \
        randn(b, hq, S, d)
    # the pairs the kernels score, as their plain versions mask them
    mask = scored_pairs(fa, q, S, kv_mask, layout, call, bk)
    pairs = int(mask.expand(b, 1, S, S).sum()) * hq

    # -- the forward kernel against its plain version; its (o, m, l) are the
    # residuals of both backwards below
    o, m, l = fa.flash_attention_forward(q, k, v, kv_mask, layout, **call)
    torch.cuda.synchronize()
    fplain = plain_by_heads(torch, fa.flash_attention_forward_plain,
                            (q, k, v), (kv_mask, layout), call)
    f_errs = (float((o.float() - fplain[0].float()).abs().max()),
              rel_err(m, fplain[1]), rel_err(l, fplain[2]))
    del fplain
    print(f"[train-kernel] flash_fwd_sm90 {shape}: max |o - plain| "
          f"{f_errs[0]:.3g}, m rel {f_errs[1]:.3g}, l rel {f_errs[2]:.3g}",
          flush=True)
    check(f_errs[0] <= 2e-2, f"flash_fwd_sm90 {shape}: max |o - plain| "
                             f"{f_errs[0]}")
    check(f_errs[1] <= 1e-2 and f_errs[2] <= 1e-2,
          f"flash_fwd_sm90 {shape}: m/l relative error {f_errs[1:]} > 1e-2")
    fmma = {}
    if mma:
        mo = fa.flash_attention_forward(q, k, v, kv_mask, layout, **call,
                                        _mma_body=True)
        torch.cuda.synchronize()
        fmma["mma_max_abs_err"] = float((mo[0].float() - o.float()).abs().max())
        check(fmma["mma_max_abs_err"] <= 2e-2,
              f"flash_fwd {shape}: the mma.sync body's o against the sm90 "
              f"body's {fmma['mma_max_abs_err']}")
        del mo
    res = (q, k, v, o, do, m, l, kv_mask, layout)

    # -- correctness: kernels against the plain backward --------------------
    got = fa.flash_attention_backward(*res, **call)
    torch.cuda.synchronize()
    want = plain_by_heads(torch, fa.flash_attention_backward_plain,
                          res[:7], res[7:], call)
    errs = dict(zip(("dq", "dk", "dv"), map(scaled_err, got, want)))
    abs_errs = {n: float((g.float() - w.float()).abs().max())
                for n, g, w in zip(("dq", "dk", "dv"), got, want)}
    mma_errs = mma_abs_errs = {}
    if mma:
        ops_ = fa.prepare_backward(*res, **call)
        mma_got = (fa.launch_dq(ops_, _mma_body=True),
                   *fa.launch_dkv(ops_, _mma_body=True))
        del ops_
        mma_errs = dict(zip(("dq", "dk", "dv"), map(scaled_err, mma_got,
                                                    want)))
        mma_abs_errs = {n: float((g.float() - w.float()).abs().max())
                        for n, g, w in zip(("dq", "dk", "dv"), mma_got, want)}
        del mma_got
    # an all-zero gradient would agree with the kernel's trivially
    check(all(float(w.float().abs().max()) > 0 for w in want),
          "the plain backward gave an all-zero gradient")
    del want
    print(f"[train-kernel] {shape}: scaled |grad - plain| {errs} (the "
          f"mma.sync body {mma_errs})", flush=True)
    for name, e in (*errs.items(), *mma_errs.items()):
        check(e <= 2e-2, f"flash_bwd {shape}: {name} scaled error {e} > 2e-2")
    # deterministic: no atomics, the GQA sum in a fixed order
    again = fa.flash_attention_backward(*res, **call)
    check(all(torch.equal(a, g) for a, g in zip(again, got)),
          f"flash_bwd {shape}: two calls of the pair are not bit-identical")
    del again

    # -- times: each kernel alone (one input set exceeds 2x L2), the body
    # the path launches (backward_body) and, beside it, the mma.sync body
    ops_ = fa.prepare_backward(*res, **call)
    check(ops_.body == "sm90", f"flash_bwd {shape}: body {ops_.body}, not sm90")
    dq_ms = device_ms(torch, [lambda: fa.launch_dq(ops_)])
    dkv_ms = device_ms(torch, [lambda: fa.launch_dkv(ops_)])
    if mma:
        fmma["mma_dq_ms"] = device_ms(torch, [lambda: fa.launch_dq(
            ops_, _mma_body=True)])
        fmma["mma_dkv_ms"] = device_ms(torch, [lambda: fa.launch_dkv(
            ops_, _mma_body=True)])
        fmma["fwd_mma_ms"] = device_ms(torch, [
            lambda: fa.flash_attention_forward(q, k, v, kv_mask, layout,
                                               **call, _mma_body=True)])
    del ops_
    bwd_ms, pair_ms = timed(torch, [lambda: fa.flash_attention_backward(
        *res, **call)])
    plain_ms = device_ms(torch, [lambda: plain_by_heads(
        torch, fa.flash_attention_backward_plain, res[:7], res[7:], call)],
        warmup=1, iters=3)
    fwd_ms, fwd_call_ms = timed(torch, [lambda: fa.flash_attention_forward(
        q, k, v, kv_mask, layout, **call)])
    fwd_plain_ms = device_ms(torch, [lambda: plain_by_heads(
        torch, fa.flash_attention_forward_plain, (q, k, v), (kv_mask, layout),
        call)], warmup=1, iters=3)

    # -- library yardstick: SDPA's backward alone, same mask, GQA ----------
    sdpa = torch.nn.functional.scaled_dot_product_attention
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = sdpa(*leaves, attn_mask=mask, scale=scale, enable_gqa=True)
    lib_bwd_ms = device_ms(torch, [lambda: torch.autograd.grad(
        out, leaves, do, retain_graph=True)])
    del out, leaves
    lib_fwd_ms = device_ms(torch, [lambda: sdpa(q, k, v, attn_mask=mask,
                                              scale=scale, enable_gqa=True)])
    mma_note = (f"; the mma.sync body {fmma['mma_dq_ms'] + fmma['mma_dkv_ms']:.4f}"
                f": dq {fmma['mma_dq_ms']:.4f}, dkv {fmma['mma_dkv_ms']:.4f}"
                if mma else "")
    print(f"[train-kernel] backward pair against SDPA's backward: dq + dkv "
          f"{dq_ms + dkv_ms:.4f} ms on the card (dq {dq_ms:.4f}, dkv "
          f"{dkv_ms:.4f}{mma_note}); the whole "
          f"flash_attention_backward {bwd_ms:.4f} ms "
          f"on the card, {pair_ms:.4f} ms a call; SDPA backward "
          f"{lib_bwd_ms:.4f} ms: the pair {(dq_ms + dkv_ms) / lib_bwd_ms:.2f}x "
          f"SDPA's time; the forward {fwd_ms:.4f} ms"
          + (f" (its mma.sync body {fmma['fwd_mma_ms']:.4f})" if mma else "")
          + f", SDPA's forward {lib_fwd_ms:.4f}", flush=True)

    # -- bounds: each input read once, each output written once; FLOPs of
    # the minimal backward, 5 products of 2d per unmasked pair, split as
    # dkv: S, dP, dV, dK (8d) and dq: dQ (2d) so the two bounds add up
    ins = nbytes(q, k, v, do, m, l, layout, seg, seg, kv_mask) \
        + m.numel() * 4                                          # + D
    return {
        "shape": shape, "call": call, "layout": layout, "res": res,
        "errs": errs, "abs_errs": abs_errs, "f_errs": f_errs,
        "mma_errs": mma_errs, "mma_abs_errs": mma_abs_errs, **fmma,
        "dq_ms": dq_ms, "dkv_ms": dkv_ms, "bwd_ms": bwd_ms,
        "cta_mode": _fwd_mode(torch, b, hq, S // bq, -(-S // 64)),
        "pair_ms": pair_ms, "plain_ms": plain_ms, "fwd_ms": fwd_ms,
        "fwd_call_ms": fwd_call_ms, "fwd_plain_ms": fwd_plain_ms,
        "lib_bwd_ms": lib_bwd_ms, "lib_fwd_ms": lib_fwd_ms,
        "dq_bound": bound(ins + nbytes(got[0]), 2.0 * d * pairs,
                          BF16_FLOPS_PER_S),
        "dkv_bound": bound(ins + nbytes(got[1], got[2]), 8.0 * d * pairs,
                           BF16_FLOPS_PER_S),
        "fwd_bound": bound(nbytes(q, k, v, o, m, l, layout, seg, seg,
                                  kv_mask),
                           4.0 * d * pairs, BF16_FLOPS_PER_S)}


def shape_entries(c: dict) -> dict:
    """One case of ``fwd_bwd_case`` as the sub-entries of the forward and
    of the dq / dkv kernels at that shape."""
    fwd = {"shape": c["shape"], "ms": c["fwd_ms"], "call_ms": c["fwd_call_ms"],
           "plain_ms": c["fwd_plain_ms"], "bound_ms": c["fwd_bound"][0],
           "bound_by": c["fwd_bound"][1], "library_ms": c["lib_fwd_ms"],
           "max_abs_err": c["f_errs"][0], "m_rel_err": c["f_errs"][1],
           "l_rel_err": c["f_errs"][2], "cta_mode": c["cta_mode"]}
    if "fwd_mma_ms" in c:
        fwd.update(mma_ms=c["fwd_mma_ms"],
                   mma_max_abs_err=c["mma_max_abs_err"])
    out = {"flash_fwd_sm90": fwd}
    for name, ms, mma, (b_ms, b_by), grads in (
            ("flash_bwd_dq_sm90", c["dq_ms"], "mma_dq_ms", c["dq_bound"],
             ("dq",)),
            ("flash_bwd_dkv_sm90", c["dkv_ms"], "mma_dkv_ms",
             c["dkv_bound"], ("dk", "dv"))):
        if mma in c:
            mma = {"mma_ms": c[mma],
                   "mma_pair_device_ms": c["mma_dq_ms"] + c["mma_dkv_ms"]}
        else:
            mma = {}
        out[name] = {"shape": c["shape"], "ms": ms, **mma,
                     "plain_ms": c["plain_ms"], "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": c["lib_bwd_ms"],
                     "max_abs_err": max(c["abs_errs"][g] for g in grads),
                     "scaled_err": max(c["errs"][g] for g in grads),
                     "pair_device_ms": c["dq_ms"] + c["dkv_ms"],
                     "backward_ms": c["bwd_ms"], "pair_ms": c["pair_ms"]}
    for name, e in out.items():
        mma = f", mma.sync body {e['mma_ms']:.4f} ms" if "mma_ms" in e else ""
        print(f"[kernel] {name} at {e['shape']}: {e['ms']:.4f} ms on the card "
              f"(plain {e['plain_ms']:.3f} ms, bound {e['bound_ms']:.4f} ms by "
              f"{e['bound_by']}, SDPA {e['library_ms']:.4f} ms{mma})", flush=True)
    return out


def train_kernel_phase(torch, seed: int) -> tuple[list[dict], dict]:
    """``fwd_bwd_case`` at the per-layer shape of the training phase, then
    a dropout forward + backward and a "paper" forward against the plain
    versions; returns the two backward records and the forward's numbers
    at this shape."""
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 10)
    b, hq, hkv, S, d = 4, 32, 8, 2048, 64
    seg = torch.as_tensor(SyntheticLM(49155, S, b, seed=seed).batch_at(0)
                          ["segment_ids"]).to(dev)
    c = fwd_bwd_case(torch, gen, b, hq, hkv, S, d, True, seg, mma=True)
    shape, call, layout = c["shape"], c["call"], c["layout"]
    q, k, v, o, do, m, l = c["res"][:7]
    bq, bk = call["block_q"], call["block_k"]
    # the walks of the two kernels' CTAs: dq's the tiles of its layout row,
    # dkv's the q-blocks of its layout column times the n_rep heads
    runs = layout.reshape(-1, S // bq, S // bk) != 0
    row_walk = runs.sum(dim=2).float()
    col_walk = runs.sum(dim=1).float() * (hq // hkv)
    walks = {"dq_tiles_mean": float(row_walk.mean()),
             "dq_tiles_max": int(row_walk.max()),
             "dkv_items_mean": float(col_walk.mean()),
             "dkv_items_max": int(col_walk.max())}
    print(f"[train-kernel] CTA walks at the train layer: dq "
          f"{walks['dq_tiles_mean']:.2f} kv tiles a CTA (max "
          f"{walks['dq_tiles_max']}), dkv {walks['dkv_items_mean']:.2f} "
          f"(q-block, head) items a CTA (max {walks['dkv_items_max']})",
          flush=True)

    # -- dropout 0.1: forward and backward against the plain versions ------
    dcall = dict(call, dropout_p=0.1, dropout_seed=seed + 7,
                 dropout_dims=(S, S))
    dout = fa.flash_attention_forward(q, k, v, None, layout, **dcall)
    torch.cuda.synchronize()
    dplain = fa.flash_attention_forward_plain(q, k, v, None, layout, **dcall)
    d_o_err = float((dout[0].float() - dplain[0].float()).abs().max())
    check(d_o_err <= 2e-2, f"flash_fwd dropout: max |o - plain| {d_o_err}")
    check(rel_err(dout[1], dplain[1]) <= 1e-2 and rel_err(dout[2], dplain[2])
          <= 1e-2, "flash_fwd dropout: m/l differ from the plain version")
    dres = (q, k, v, dout[0], do, dout[1], dout[2], None, layout)
    dgot = fa.flash_attention_backward(*dres, **dcall)
    torch.cuda.synchronize()
    dwant = fa.flash_attention_backward_plain(*dres, **dcall)
    derrs = dict(zip(("dq", "dk", "dv"), map(scaled_err, dgot, dwant)))
    del dwant, dplain, dout
    print(f"[train-kernel] dropout 0.1: max |o - plain| {d_o_err:.3g}, "
          f"scaled |grad - plain| {derrs}", flush=True)
    for name, e in derrs.items():
        check(e <= 2e-2, f"flash_bwd dropout: {name} scaled error {e} > 2e-2")
    again = fa.flash_attention_backward(*dres, **dcall)
    check(all(torch.equal(a, g) for a, g in zip(again, dgot)),
          "flash_bwd dropout: two calls of the pair are not bit-identical")
    del again
    print("[train-kernel] two calls of the pair bit-identical, without and "
          "with dropout 0.1", flush=True)
    fwd_drop_ms = device_ms(torch, [lambda: fa.flash_attention_forward(
        q, k, v, None, layout, **dcall)])
    dops = fa.prepare_backward(*dres, **dcall)
    dq_drop_ms = device_ms(torch, [lambda: fa.launch_dq(dops)])
    dkv_drop_ms = device_ms(torch, [lambda: fa.launch_dkv(dops)])
    mma_dq_drop_ms = device_ms(torch, [lambda: fa.launch_dq(dops, _mma_body=True)])
    mma_dkv_drop_ms = device_ms(torch, [lambda: fa.launch_dkv(dops, _mma_body=True)])

    # -- variant "paper": forward against the plain version ----------------
    pcall = dict(call, variant="paper")
    pout = fa.flash_attention_forward(q, k, v, None, layout, **pcall)
    torch.cuda.synchronize()
    pplain = fa.flash_attention_forward_plain(q, k, v, None, layout, **pcall)
    p_err = float((pout[0].float() - pplain[0].float()).abs().max())
    check(p_err <= 2e-2, f"flash_fwd paper: max |o - plain| {p_err} > 2e-2")
    fwd_paper_ms = device_ms(torch, [lambda: fa.flash_attention_forward(
        q, k, v, None, layout, **pcall)])

    lib = "SDPA backward (dq, dk, dv together), bool mask, GQA"
    recs = []
    # each of #2 / #3 twice: the sm90 body (wgmma, TMA) that the bf16 paths
    # at d 64 / 96 / 128 launch, and flash_bwd.cu's mma.sync body, forced
    # here, which no main path launches (MMA_BODY_NOTE)
    mma_pair = c["mma_dq_ms"] + c["mma_dkv_ms"]
    for name, ms, (b_ms, b_by), grads, drop_ms, line, source, extra in (
            ("flash_bwd_dq_sm90", c["dq_ms"], c["dq_bound"], ("dq",),
             dq_drop_ms, 581, "flash_bwd_sm90.cu",
             {"mma_ms": c["mma_dq_ms"], "mma_dropout_ms": mma_dq_drop_ms,
              "mma_pair_device_ms": mma_pair}),
            ("flash_bwd_dkv_sm90", c["dkv_ms"], c["dkv_bound"], ("dk", "dv"),
             dkv_drop_ms, 612, "flash_bwd_sm90.cu",
             {"mma_ms": c["mma_dkv_ms"], "mma_dropout_ms": mma_dkv_drop_ms,
              "mma_pair_device_ms": mma_pair}),
            ("flash_bwd_dq", c["mma_dq_ms"], c["dq_bound"], ("dq",),
             mma_dq_drop_ms, 581, "flash_bwd.cu", MMA_BODY_NOTE),
            ("flash_bwd_dkv", c["mma_dkv_ms"], c["dkv_bound"], ("dk", "dv"),
             mma_dkv_drop_ms, 612, "flash_bwd.cu", MMA_BODY_NOTE)):
        pre = "" if source == "flash_bwd_sm90.cu" else "mma_"
        err = max(c[pre + "errs"][g] for g in grads)
        rec = {"name": name, "route": "cuda",
               "source": f"src/repro_torch/kernels/csrc/{source}",
               "replaces": f"src/repro/kernels/flash_attention.py:{line}",
               "launches": None,
               "max_abs_err": max(c[pre + "abs_errs"][g] for g in grads),
               "scaled_err": err, "ms": ms, "plain_ms": c["plain_ms"],
               "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": c["lib_bwd_ms"], "library": lib,
               "shape": shape, "dropout_ms": drop_ms,
               "pair_ms": c["pair_ms"],
               "pair_device_ms": c["dq_ms"] + c["dkv_ms"],
               "backward_ms": c["bwd_ms"],
               "plain_ms_is": "the plain backward (dq, dk, dv together)",
               **extra}
        recs.append(rec)
        print(f"[kernel] {name}: {shape}: scaled err {err:.3g}; {ms:.4f} ms "
              f"(dropout 0.1: {drop_ms:.4f} ms; plain backward "
              f"{c['plain_ms']:.3f} ms, bound {b_ms:.4f} ms by {b_by}, {lib} "
              f"{c['lib_bwd_ms']:.4f} ms)", flush=True)
    fwd = {"shape": shape, "ms": c["fwd_ms"], "call_ms": c["fwd_call_ms"],
           "dropout_ms": fwd_drop_ms,
           "paper_ms": fwd_paper_ms, "plain_ms": c["fwd_plain_ms"],
           "bound_ms": c["fwd_bound"][0], "bound_by": c["fwd_bound"][1],
           "library_ms": c["lib_fwd_ms"], "max_abs_err": c["f_errs"][0],
           "m_rel_err": c["f_errs"][1], "l_rel_err": c["f_errs"][2],
           "dropout_max_abs_err": d_o_err,
           "paper_max_abs_err": p_err, "bwd_pair_ms": c["pair_ms"],
           "bwd_pair_device_ms": c["dq_ms"] + c["dkv_ms"],
           "bwd_ms": c["bwd_ms"], "bwd_cta_walks": walks,
           "dropout_grad_errs": derrs, "cta_mode": c["cta_mode"],
           "mma_ms": c["fwd_mma_ms"], "mma_max_abs_err": c["mma_max_abs_err"]}
    print(f"[kernel] flash_fwd_sm90 at the train shape: {c['fwd_ms']:.4f} ms "
          f"on the card (the mma.sync body {c['fwd_mma_ms']:.4f}; "
          f"{c['fwd_call_ms']:.4f} ms a call), dropout "
          f"0.1 {fwd_drop_ms:.4f} ms, paper {fwd_paper_ms:.4f} ms (plain "
          f"{c['fwd_plain_ms']:.3f} ms, bound {c['fwd_bound'][0]:.4f} ms by "
          f"{c['fwd_bound'][1]}, SDPA forward {c['lib_fwd_ms']:.4f} ms); "
          f"backward pair {c['pair_ms']:.4f} ms", flush=True)
    return recs, fwd


def new_shape_kernel_phase(torch, seed: int) -> dict:
    """The kernels at the shapes of the later training paths: #1/#2/#3
    at train-bert's attention layer (non-causal, its packed documents, d
    64, MHA), at train-olmo's (causal, d 128, MHA) and at train-hymba's
    (causal, window 1024, d 64, GQA 25/5), each through ``fwd_bwd_case``
    (its shape naming the layout's skipped tiles). Returns {kernel: {path:
    entry}}; the serves' kernels are held at their own calls
    (``serve_shape_records_apart``)."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 20)
    at: dict = {}
    for path, (arch, S, b) in NEW_TRAIN_PATHS.items():
        cfg = get_config(arch)
        # the segments of the path's first batch
        seg = torch.as_tensor(SyntheticLM(cfg.vocab_size, S, b, seed=seed)
                              .batch_at(0)["segment_ids"]).to(dev)
        c = fwd_bwd_case(torch, gen, b, cfg.num_heads, cfg.num_kv_heads, S,
                         cfg.head_dim, cfg.causal, seg, window=cfg.window,
                         mma=path in MMA_SHAPES)
        skipped = int((c["layout"] == 0).sum())
        c["shape"] += f", {skipped} of {c['layout'].numel()} tiles skipped"
        for name, e in shape_entries(c).items():
            at.setdefault(name, {})[path] = e
        del c
        release(torch)
    return at


def moe_layer_phase(torch, seed: int, card: str) -> dict:
    """One MoE layer at olmoe-1b-7b's width (64 experts of d_ff 1024,
    top-8, d 2048, capacity factor 1.25), bf16, forward + backward over
    train-olmoe's tokens (4 rows of 2048): two calls bit-identical (the
    dispatch and combine are gathers both ways, no atomics), a third under
    ``torch.cuda.set_sync_debug_mode("error")`` (no host sync) with the
    same bits; its device time per call, and the share of it in GEMM
    kernels (the expert einsums and the router product) beside their
    bound."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import moe

    dev = torch.device("cuda")
    cfg = get_config(TRAIN_OLMOE[0])
    b, s = TRAIN_OLMOE[2], TRAIN_OLMOE[1]
    gen = torch.Generator(device=dev).manual_seed(seed + 40)
    params = moe.init_moe(cfg, torch.bfloat16, generator=gen, device=dev)
    x = torch.randn(b, s, cfg.d_model, generator=gen, device=dev,
                    dtype=torch.bfloat16)
    cot = torch.randn(x.shape, generator=gen, device=dev,
                      dtype=torch.bfloat16)

    def run():
        leaves = {n: t.detach().requires_grad_() for n, t in params.items()}
        xx = x.detach().requires_grad_()
        y, aux = moe.apply_moe(leaves, cfg, xx)
        return (y, aux, *torch.autograd.grad((y * cot).float().sum() + aux,
                                             [xx, *leaves.values()]))

    first, second = run(), run()
    same = all(torch.equal(a, c) for a, c in zip(first, second))
    check(same, "moe layer: two forward + backward calls differ")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        third = run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(all(torch.equal(a, c) for a, c in zip(first, third)),
          "moe layer: the call under set_sync_debug_mode differs")
    del first, second, third
    ms = device_ms(torch, [run], iters=5)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            run()
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    total = sum(_device_us(e) for e in kernels)
    gemm = sum(_device_us(e) for e in kernels
               if re.search(r"gemm|xmma|nvjet|cutlass", e.key, re.I))
    cap = moe.capacity(cfg, s)
    rows = b * cfg.num_experts * cap
    # three expert products forward, twice that backward; the router's
    flops = (18.0 * rows * cfg.d_model * cfg.d_ff
             + 6.0 * b * s * cfg.d_model * cfg.num_experts)
    g_bound = flops / BF16_FLOPS_PER_S * 1e3
    top = sorted(kernels, key=_device_us, reverse=True)[:6]
    rec = {"shape": f"x ({b}, {s}, {cfg.d_model}) bf16, {cfg.num_experts} "
                    f"experts of d_ff {cfg.d_ff}, top-{cfg.num_experts_per_token}"
                    f", capacity {cap} rows an expert a row",
           "bit_identical": same, "no_host_sync": True, "ms": ms,
           "gemm_ms": gemm / 1e3 / 5, "gemm_share": gemm / total if total else None,
           "gemm_bound_ms": g_bound, "card": card,
           "top": [{"kernel": e.key[:90], "count": e.count // 5,
                    "device_ms": _device_us(e) / 1e3 / 5} for e in top]}
    share = (f"{rec['gemm_ms']:.3f} ms ({rec['gemm_share']:.1%})" if total
             else "not measured (the profile recorded no device time)")
    print(f"[moe] layer forward + backward at {rec['shape']}: two calls "
          f"bit-identical, no host sync under set_sync_debug_mode('error'); "
          f"{ms:.3f} ms on the card a call, GEMM kernels {share}, their "
          f"bound {g_bound:.3f} ms by operations [{card}]", flush=True)
    for t in rec["top"]:
        print(f"[moe]   {t['device_ms']:8.3f} ms  x{t['count']:<4} "
              f"{t['kernel']}", flush=True)
    return rec


def ssm_layer_bound_ms(cfg, b: int, s: int) -> tuple[float, float, float]:
    """The least time of one SSM layer's forward + backward (three times
    the forward's matmul FLOPs) over (b, s) tokens at ``cfg``'s width:
    the two projections in bf16 on the tensor cores, plus the SSD scan's
    products in float32 (outside them): the chunk scores C·B, their
    product with dt·x over the (Q, Q) decay-masked pairs, the chunk-end
    states and the inter-chunk output. Returns (bound ms, projection
    GFLOP, scan GFLOP), both GFLOP forward + backward."""
    d_inner, h, p, n = (cfg.ssm_d_inner, cfg.ssm_num_heads, cfg.ssm_head_dim,
                        cfg.ssm_state)
    q = cfg.ssm_chunk
    chunks = b * math.ceil(s / q)
    proj = 3 * 2.0 * b * s * cfg.d_model * (3 * d_inner + 2 * n + h)
    scan = 3 * chunks * (2.0 * q * q * n + 2.0 * h * q * q * p
                         + 4.0 * h * q * p * n)
    ms = (proj / BF16_FLOPS_PER_S + scan / FP32_FLOPS_PER_S) * 1e3
    return ms, proj / 1e9, scan / 1e9


def ssm_layer_phase(torch, seed: int, card: str) -> dict:
    """One SSM layer at mamba2-2.7b's width (d 2560, 80 heads of 64, state
    128, chunks of 256), bf16, forward + backward over train-mamba2's
    tokens (4 rows of 2048): two calls bit-identical, a third under
    ``torch.cuda.set_sync_debug_mode("error")`` (no host sync: the chunk
    loop reads nothing back) with the same bits; its peak memory above its
    inputs, its device time per call and the share of it in GEMM kernels
    beside the layer's bound (``ssm_layer_bound_ms``)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import ssm

    dev = torch.device("cuda")
    arch, s, b = SSM_LAYER
    cfg = get_config(arch)
    gen = torch.Generator(device=dev).manual_seed(seed + 50)
    params = ssm.init_ssm(cfg, torch.bfloat16, generator=gen, device=dev)
    x = torch.randn(b, s, cfg.d_model, generator=gen, device=dev,
                    dtype=torch.bfloat16)
    cot = torch.randn(x.shape, generator=gen, device=dev,
                      dtype=torch.bfloat16)

    def run():
        leaves = {n: t.detach().requires_grad_() for n, t in params.items()}
        xx = x.detach().requires_grad_()
        y = ssm.apply_ssm(leaves, cfg, xx)
        return (y, *torch.autograd.grad((y * cot).float().sum(),
                                        [xx, *leaves.values()]))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    first = run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    second = run()
    same = all(torch.equal(a, c) for a, c in zip(first, second))
    check(same, "ssm layer: two forward + backward calls differ")
    check(all(bool(torch.isfinite(t).all()) for t in first),
          "ssm layer: a non-finite output or gradient")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        third = run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(all(torch.equal(a, c) for a, c in zip(first, third)),
          "ssm layer: the call under set_sync_debug_mode differs")
    del first, second, third
    ms = device_ms(torch, [run], iters=5)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            run()
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    total = sum(_device_us(e) for e in kernels)
    gemm = sum(_device_us(e) for e in kernels
               if re.search(r"gemm|xmma|nvjet|cutlass", e.key, re.I))
    g_bound, proj_gf, scan_gf = ssm_layer_bound_ms(cfg, b, s)
    top = sorted(kernels, key=_device_us, reverse=True)[:8]
    rec = {"shape": f"x ({b}, {s}, {cfg.d_model}) bf16, {cfg.ssm_num_heads} "
                    f"heads of {cfg.ssm_head_dim}, state {cfg.ssm_state}, "
                    f"chunk {cfg.ssm_chunk}",
           "bit_identical": same, "no_host_sync": True, "ms": ms,
           "peak_memory_bytes": peak,
           "gemm_ms": gemm / 1e3 / 5, "gemm_share": gemm / total if total else None,
           "bound_ms": g_bound, "proj_gflop": proj_gf, "scan_gflop": scan_gf,
           "card": card,
           "top": [{"kernel": e.key[:90], "count": e.count // 5,
                    "device_ms": _device_us(e) / 1e3 / 5} for e in top]}
    share = (f"{rec['gemm_ms']:.3f} ms ({rec['gemm_share']:.1%})" if total
             else "not measured (the profile recorded no device time)")
    print(f"[ssm] layer forward + backward at {rec['shape']}: two calls "
          f"bit-identical, no host sync under set_sync_debug_mode('error'); "
          f"{ms:.3f} ms on the card a call, GEMM kernels {share}, bound "
          f"{g_bound:.3f} ms ({proj_gf:.0f} GFLOP of bf16 projections, "
          f"{scan_gf:.0f} GFLOP of float32 scan products); peak memory "
          f"{peak / 2**30:.2f} GiB above its inputs [{card}]", flush=True)
    for t in rec["top"]:
        print(f"[ssm]   {t['device_ms']:8.3f} ms  x{t['count']:<4} "
              f"{t['kernel']}", flush=True)
    return rec


# ---------------------------------------------------------------------------
# phase 2c: the trainable paged prefill's backward kernels
# ---------------------------------------------------------------------------

def paged_grad_case(torch, seed: int, *, requires_grad=False, hq=32, hkv=8,
                    d=64) -> dict:
    """The paged prefill at the serving shapes of flash_fwd_paged (chunks of
    192 and 64 rows against 1536- and 600-token prefixes, page 16, bf16;
    granite's hq 32 / hkv 8 / d 64 unless given: qwen3-32b's are 64 / 8 /
    128), one row per sequence: both rows' first prefix page is the same
    pool page (a shared prefix), two dead slots per row, the short row's q
    tail padded. Returns the inputs, the compiled layout and the call's
    keyword arguments."""
    from repro_torch.core import masks as M
    from repro_torch.kernels import tuning

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 20)
    ps, num_pages = 16, 400
    spans, chunks = [1536, 600], [192, 64]
    sq = max(chunks)
    T = max(-(-s // ps) for s in spans) + 2
    pages = torch.randperm(num_pages, generator=gen, device=dev).int()
    page_list = torch.full((2, T), -1, dtype=torch.int32, device=dev)
    kv_seg = torch.full((2, T * ps), M.SEG_PAD_KV, dtype=torch.int32, device=dev)
    kv_pos = torch.full((2, T * ps), M.POS_PAD, dtype=torch.int32, device=dev)
    q_seg = torch.full((2, sq), M.SEG_PAD_Q, dtype=torch.int32, device=dev)
    q_pos = torch.full((2, sq), M.POS_PAD, dtype=torch.int32, device=dev)
    nxt = 1
    for r, (span, n) in enumerate(zip(spans, chunks)):
        np_ = -(-span // ps)
        page_list[r, 0] = pages[0]                       # the shared page
        page_list[r, 1:np_] = pages[nxt:nxt + np_ - 1]
        nxt += np_ - 1
        kv_seg[r, :span] = 0
        kv_pos[r, :span] = torch.arange(span, device=dev)
        q_seg[r, :n] = 0
        q_pos[r, :n] = torch.arange(span - n, span, device=dev)

    def randn(*shape):
        t = torch.randn(*shape, generator=gen, device=dev, dtype=torch.bfloat16)
        return t.requires_grad_() if requires_grad else t

    ids = dict(q_segment_ids=q_seg, kv_segment_ids=kv_seg, q_positions=q_pos,
               kv_positions=kv_pos)
    bq = tuning.fwd_tiles(d)[0]
    spec = M.MaskSpec(causal=True, **ids)
    layout = M.compile_block_layout(spec, sq, T * ps, bq, ps).as_array(dev)
    layout = M.paged_prefill_block_layout(layout, page_list)
    return {"q": randn(2, hq, sq, d), "k_pool": randn(hkv, num_pages, ps, d),
            "v_pool": randn(hkv, num_pages, ps, d), "page_list": page_list,
            "do": randn(2, hq, sq, d).detach(), "ids": ids, "layout": layout,
            "mask": spec.element_mask(sq, T * ps),   # (2, 1, sq, T*ps) bool
            "call": dict(scale=d ** -0.5, causal=True, window=None,
                         block_q=bq, **ids),
            "shape": f"chunks {chunks} against paged prefixes {spans} "
                     f"(one row each, first page shared, 2 dead slots), "
                     f"page {ps}, {hq} q / {hkv} kv heads of {d}"}


def paged_pair_case(torch, c: dict) -> dict:
    """One paged backward case on the card: the sm90 pair (the body
    ``backward_body`` names at these tiles) through
    ``flash_prefill_paged_backward`` against the plain backward over the
    gathered pages and against flash_bwd.cu's mma.sync pair forced with
    ``_mma_body`` (dq, dk_pool, dv_pool within 2e-2 of their max each),
    untouched pages exactly zero, two calls bit-identical, the whole
    backward free of host syncs (``torch.cuda.set_sync_debug_mode
    ("error")``); then each kernel of both bodies, the fold, the whole
    backward, the plain version and SDPA's backward on pre-gathered K/V
    timed in turns, with the pair's bounds."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import gather_pages

    q, k_pool, v_pool, page_list = c["q"], c["k_pool"], c["v_pool"], c["page_list"]
    call, d = c["call"], q.shape[-1]
    ps, T = k_pool.shape[2], page_list.shape[1]
    nq = c["layout"].shape[-2]
    body = fa.backward_body(on_card=True, dtype=q.dtype, head_dim=d,
                            block_q=call["block_q"], block_k=ps, paged=True,
                            nq=nq, nk=T)
    check(body == "sm90", f"paged backward at {c['shape']}: the body rule "
                          f"names {body!r}, not the sm90 pair")
    o, m, l = fa.flash_prefill_paged_forward(q, k_pool, v_pool, page_list,
                                             c["layout"], **call)
    res = (q, k_pool, v_pool, page_list, o, c["do"], m, l, c["layout"])
    n0 = dict(fa.LAUNCHES)
    got = fa.flash_prefill_paged_backward(*res, **call)
    torch.cuda.synchronize()
    for name in ("flash_bwd_dq_paged", "flash_bwd_dkv_paged"):
        check(fa.LAUNCHES[name + "_sm90"] == n0[name + "_sm90"] + 1
              and fa.LAUNCHES[name] == n0[name],
              f"paged backward at {c['shape']}: {name}_sm90 did not launch "
              f"once (or the mma.sync body ran)")
    want = fa.flash_prefill_paged_backward_plain(*res, **call)
    mma = fa.flash_prefill_paged_backward(*res, **call, _mma_body=True)
    torch.cuda.synchronize()
    names = ("dq", "dk_pool", "dv_pool")
    errs = dict(zip(names, map(scaled_err, got, want)))
    abs_errs = {n: float((g.float() - w.float()).abs().max())
                for n, g, w in zip(names, got, want)}
    mma_errs = dict(zip(names, map(scaled_err, mma, want)))
    mma_abs = {n: float((g.float() - w.float()).abs().max())
               for n, g, w in zip(names, mma, want)}
    vs_mma = dict(zip(names, map(scaled_err, got, mma)))
    check(all(float(w.float().abs().max()) > 0 for w in want),
          "the plain paged backward gave an all-zero gradient")
    named = torch.zeros(k_pool.shape[1], dtype=torch.bool, device=q.device)
    named[page_list[page_list >= 0].long()] = True
    untouched_zero = all(bool((g[:, ~named] == 0).all()) for g in got[1:])
    again = fa.flash_prefill_paged_backward(*res, **call)
    torch.cuda.synchronize()
    identical = all(torch.equal(a, b) for a, b in zip(got, again))
    print(f"[paged-grad] {c['shape']}: sm90 pair scaled |grad - plain| "
          f"{errs}, |grad - mma.sync| {vs_mma}; the mma.sync pair {mma_errs}; "
          f"untouched pages zero {untouched_zero}; two calls bit-identical "
          f"{identical}", flush=True)
    for name in names:
        check(errs[name] <= 2e-2, f"paged backward: {name} scaled error "
                                  f"{errs[name]} > 2e-2")
        check(vs_mma[name] <= 2e-2, f"paged backward: {name} differs from "
                                    f"the mma.sync body by {vs_mma[name]}")
    check(untouched_zero, "paged backward: an untouched page got a gradient")
    check(identical, "paged backward: two calls differ (not deterministic)")
    torch.cuda.set_sync_debug_mode("error")
    try:
        fa.flash_prefill_paged_backward(*res, **call)
    except RuntimeError as e:
        raise SmokeFailure(f"paged backward waits on the card: {e}") from e
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print("[paged-grad] the whole backward ran under "
          "set_sync_debug_mode('error')", flush=True)
    del again, mma

    ops_ = fa.prepare_backward(q, k_pool, v_pool, o, c["do"], m, l, None,
                               c["layout"], q_offset=0, block_k=ps,
                               page_list=page_list, **call)
    check(ops_.body == "sm90", "prepare_backward did not name the sm90 pair")
    # each kernel of both bodies, in turns (sm90, mma.sync, mma.sync, sm90)
    t = {}
    for key, fn in (("dq", lambda: fa.launch_dq_paged(ops_)),
                    ("dq_mma", lambda: fa.launch_dq_paged(ops_, _mma_body=True)),
                    ("dkv", lambda: fa.launch_dkv_paged(ops_)),
                    ("dkv_mma", lambda: fa.launch_dkv_paged(ops_, _mma_body=True))):
        t[key] = [device_ms(torch, [fn])]
    for key, fn in (("dkv_mma", lambda: fa.launch_dkv_paged(ops_, _mma_body=True)),
                    ("dkv", lambda: fa.launch_dkv_paged(ops_)),
                    ("dq_mma", lambda: fa.launch_dq_paged(ops_, _mma_body=True)),
                    ("dq", lambda: fa.launch_dq_paged(ops_))):
        t[key].append(device_ms(torch, [fn]))
    ms = {k: sum(v) / len(v) for k, v in t.items()}
    full_dev_ms, full_ms = timed(torch, [lambda: fa.flash_prefill_paged_backward(
        *res, **call)])
    mma_full_ms = device_ms(torch, [lambda: fa.flash_prefill_paged_backward(
        *res, **call, _mma_body=True)])

    # the fold alone: the kernel (with its order and zeroed pools) against
    # fold_packed_to_pool, bit for bit, on the sm90 dkv kernel's packed rows
    num_pages, dtype = k_pool.shape[1], k_pool.dtype
    packed = fa.launch_dkv_paged(ops_)
    fold = fa.launch_fold_paged(*packed, page_list, num_pages, dtype)
    torch.cuda.synchronize()
    fold_plain = [fa.fold_packed_to_pool(x, page_list, num_pages).to(dtype)
                  for x in packed]
    fold_err = max(float((a.float() - b.float()).abs().max())
                   for a, b in zip(fold, fold_plain))
    check(all(torch.equal(a, b) for a, b in zip(fold, fold_plain)),
          f"flash_bwd_fold_paged differs from fold_packed_to_pool "
          f"(max {fold_err})")
    fold_ms, fold_call_ms = timed(torch, [lambda: fa.launch_fold_paged(
        *packed, page_list, num_pages, dtype)])
    fold_plain_ms = device_ms(torch, [lambda: [
        fa.fold_packed_to_pool(x, page_list, num_pages).to(dtype)
        for x in packed]], warmup=1, iters=3)
    # library: index_add_ of the live slots' rows (selected beforehand) into
    # zeroed fp32 pools, dk and dv
    flat = page_list.reshape(-1).long()
    live_idx = (flat >= 0).nonzero().squeeze(1)
    hkv_ = k_pool.shape[0]
    srcs = [x.reshape(q.shape[0], hkv_, T, ps, d).transpose(1, 2)
            .reshape(-1, hkv_, ps, d)[live_idx].transpose(0, 1).contiguous()
            for x in packed]
    fold_lib_ms = device_ms(torch, [lambda: [
        torch.zeros((hkv_, num_pages, ps, d), device=q.device).index_add_(
            1, flat[live_idx], src) for src in srcs]])
    live_slots = int(live_idx.numel())
    fold_bound = bound(2 * hkv_ * live_slots * ps * d * 4 + nbytes(page_list)
                       + nbytes(*fold), 2.0 * hkv_ * live_slots * ps * d,
                       FP32_FLOPS_PER_S)
    del packed, fold_plain, srcs
    plain_ms = device_ms(torch, [lambda: fa.flash_prefill_paged_backward_plain(
        *res, **call)], warmup=1, iters=3)
    # library: SDPA's backward alone on K/V gathered beforehand, same mask;
    # the padded q rows, which have no key, may see key 0 so SDPA's softmax
    # stays finite (only the time is used)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask = c["mask"].clone()
    mask[..., 0] |= ~mask.any(dim=-1)
    leaves = [q.detach().requires_grad_(),
              gather_pages(k_pool, page_list).requires_grad_(),
              gather_pages(v_pool, page_list).requires_grad_()]
    out = sdpa(*leaves, attn_mask=mask, scale=call["scale"], enable_gqa=True)
    lib_ms = device_ms(torch, [lambda: torch.autograd.grad(
        out, leaves, c["do"], retain_graph=True)])
    del out, leaves
    pairs = int(c["mask"].sum()) * q.shape[1]
    live = int((page_list >= 0).sum())
    kv_bytes = 2 * live * k_pool.shape[0] * ps * d * 2
    ins = (nbytes(q, c["do"], m, l, c["layout"], page_list, *c["ids"].values())
           + m.numel() * 4 + kv_bytes)                       # + D
    return {"errs": errs, "abs_errs": abs_errs, "mma_errs": mma_errs,
            "mma_abs_errs": mma_abs, "vs_mma": vs_mma, "identical": identical,
            "ms": ms, "samples": t, "backward_ms": full_dev_ms,
            "backward_call_ms": full_ms, "mma_backward_ms": mma_full_ms,
            "plain_ms": plain_ms, "lib_ms": lib_ms,
            "dq_bound": bound(ins + nbytes(got[0]), 2.0 * d * pairs,
                              BF16_FLOPS_PER_S),
            "dkv_bound": bound(ins + nbytes(got[1], got[2]), 8.0 * d * pairs,
                               BF16_FLOPS_PER_S),
            "fold": {"err": fold_err, "ms": fold_ms, "call_ms": fold_call_ms,
                     "plain_ms": fold_plain_ms, "lib_ms": fold_lib_ms,
                     "bound": fold_bound},
            "rows": {"dq": tuning_rows(torch, ops_, "dq"),
                     "dkv": tuning_rows(torch, ops_, "dkv")}}


def tuning_rows(torch, ops_, kernel: str) -> int:
    """The CTA tile ``tuning.sm90_bwd_rows`` gives a paged call's grid."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import tuning

    b, hq, hkv, nq, _ = ops_.grid
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if kernel == "dq":
        return tuning.sm90_bwd_rows(b, hq, nq, sms)
    return tuning.sm90_bwd_rows(b, hkv, fa._page_groups(ops_), sms,
                                kernel="dkv", head_dim=ops_.head_dim)


def paged_grad_kernel_phase(torch, seed: int) -> list[dict]:
    """The paged dq and dkv kernels and the fold kernel at the paged grad
    shape (``paged_pair_case``): the sm90 pair, which the path launches,
    and flash_bwd.cu's mma.sync pair beside it (``"on_main_path": false``,
    its ``ms`` the forced body's in the same run), each against the plain
    backward; the fold bit-equal to ``fold_packed_to_pool``; each kernel
    timed beside its bound, the plain version's time and one PyTorch call
    (SDPA's backward on pre-gathered K/V; ``index_add_`` for the fold), the
    whole backward by device and by event time. The sm90 records carry one
    sub-entry at qwen3-32b's heads (64 q / 8 kv of 128: dkv's 128-key tile
    at n_rep 8), checked the same way."""
    c = paged_grad_case(torch, seed)
    r = paged_pair_case(torch, c)
    shape = c["shape"]
    del c
    release(torch)
    cq = paged_grad_case(torch, seed + 3, hq=64, hkv=8, d=128)
    rq = paged_pair_case(torch, cq)
    shape_q = cq["shape"]
    del cq
    release(torch)
    lib = "SDPA backward (dq, dk, dv together) on pre-gathered K/V, bool mask"
    mma_pair = r["ms"]["dq_mma"] + r["ms"]["dkv_mma"]
    recs = []
    for name, key, grads, line in (
            ("flash_bwd_dq_paged", "dq", ("dq",), 851),
            ("flash_bwd_dkv_paged", "dkv", ("dk_pool", "dv_pool"), 897)):
        b_ms, b_by = r[f"{key}_bound"]
        common = {"route": "cuda",
                  "replaces": f"src/repro/kernels/flash_attention.py:{line}",
                  "launches": None, "plain_ms": r["plain_ms"],
                  "bound_ms": b_ms, "bound_by": b_by,
                  "library_ms": r["lib_ms"], "library": lib, "shape": shape,
                  "backward_ms": r["backward_ms"],
                  "backward_call_ms": r["backward_call_ms"],
                  "mma_backward_ms": r["mma_backward_ms"],
                  "fold_ms": r["fold"]["ms"],
                  "pair_device_ms": r["ms"]["dq"] + r["ms"]["dkv"],
                  "mma_pair_device_ms": mma_pair,
                  "deterministic": r["identical"], "no_host_sync": True,
                  "plain_ms_is": "the plain paged backward (dq, dk, dv, fold)"}
        qb_ms, qb_by = rq[f"{key}_bound"]
        qwen3 = {"shape": shape_q, "ms": rq["ms"][key],
                 "mma_ms": rq["ms"][f"{key}_mma"],
                 "max_abs_err": max(rq["abs_errs"][g] for g in grads),
                 "scaled_err": max(rq["errs"][g] for g in grads),
                 "scaled_err_vs_mma": max(rq["vs_mma"][g] for g in grads),
                 "plain_ms": rq["plain_ms"], "bound_ms": qb_ms,
                 "bound_by": qb_by, "library_ms": rq["lib_ms"],
                 "backward_ms": rq["backward_ms"],
                 "mma_backward_ms": rq["mma_backward_ms"],
                 "fold_ms": rq["fold"]["ms"], "cta_rows": rq["rows"][key],
                 "deterministic": rq["identical"]}
        rec = {"name": name + "_sm90", **common,
               "source": "src/repro_torch/kernels/csrc/flash_bwd_sm90.cu",
               "max_abs_err": max(r["abs_errs"][g] for g in grads),
               "scaled_err": max(r["errs"][g] for g in grads),
               "scaled_err_vs_mma": max(r["vs_mma"][g] for g in grads),
               "ms": r["ms"][key], "ms_samples": r["samples"][key],
               "mma_ms": r["ms"][f"{key}_mma"],
               "cta_rows": r["rows"][key], "at_qwen3_heads": qwen3}
        mma_rec = {"name": name, **common, **MMA_PAGED_NOTE,
                   "source": "src/repro_torch/kernels/csrc/flash_bwd.cu",
                   "max_abs_err": max(r["mma_abs_errs"][g] for g in grads),
                   "scaled_err": max(r["mma_errs"][g] for g in grads),
                   "ms": r["ms"][f"{key}_mma"],
                   "ms_samples": r["samples"][f"{key}_mma"]}
        recs += [rec, mma_rec]
        print(f"[kernel] {rec['name']}: {shape}: scaled err "
              f"{rec['scaled_err']:.3g}; {rec['ms']:.4f} ms [mma.sync body "
              f"{rec['mma_ms']:.4f} ms, {rec['ms'] / rec['mma_ms']:.3f}x] "
              f"(rows {rec['cta_rows']}; whole backward with the fold "
              f"{r['backward_ms']:.4f} ms on the card [mma.sync "
              f"{r['mma_backward_ms']:.4f}], {r['backward_call_ms']:.4f} ms a "
              f"call; plain backward {r['plain_ms']:.3f} ms, bound {b_ms:.4f} "
              f"ms by {b_by}, {lib} {r['lib_ms']:.4f} ms); at qwen3's heads "
              f"{qwen3['ms']:.4f} ms [mma.sync {qwen3['mma_ms']:.4f}], scaled "
              f"err {qwen3['scaled_err']:.3g}, rows {qwen3['cta_rows']}, "
              f"bound {qb_ms:.4f} ms by {qb_by}, SDPA {rq['lib_ms']:.4f} ms",
              flush=True)
    f = r["fold"]
    fold_lib = "index_add_ of the live slots' rows into zeroed fp32 pools, dk and dv"
    rec = {"name": "flash_bwd_fold_paged", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_bwd.cu",
           "replaces": "src/repro/kernels/flash_attention.py:930",
           "launches": None, "max_abs_err": f["err"], "ms": f["ms"],
           "call_ms": f["call_ms"], "plain_ms": f["plain_ms"],
           "bound_ms": f["bound"][0], "bound_by": f["bound"][1],
           "library_ms": f["lib_ms"], "library": fold_lib,
           "shape": shape, "at_qwen3_heads": {
               "shape": shape_q, "ms": rq["fold"]["ms"],
               "max_abs_err": rq["fold"]["err"],
               "bound_ms": rq["fold"]["bound"][0],
               "bound_by": rq["fold"]["bound"][1],
               "library_ms": rq["fold"]["lib_ms"]},
           "ms_is": "launch_fold_paged: the order sort, the zeroed pools and "
                    "the fold kernel",
           "plain_ms_is": "fold_packed_to_pool of dk and dv, cast to bf16"}
    recs.append(rec)
    print(f"[kernel] flash_bwd_fold_paged: {shape}: bit-equal to "
          f"fold_packed_to_pool; {f['ms']:.4f} ms on the card, "
          f"{f['call_ms']:.4f} ms a call (plain {f['plain_ms']:.3f} ms, bound "
          f"{f['bound'][0]:.4f} ms by {f['bound'][1]}, {fold_lib} "
          f"{f['lib_ms']:.4f} ms); the sm90 pair + fold "
          f"{r['ms']['dq'] + r['ms']['dkv'] + f['ms']:.4f} ms against SDPA's "
          f"backward {r['lib_ms']:.4f} ms", flush=True)
    return recs


def paged_grad_ab(torch, seed: int) -> dict:
    """For ``--ab``: device time of the paged dq and dkv kernels, and the
    whole paged backward's device and event time, at phase 2c's shape,
    through calls that both checkouts' packages have."""
    from repro_torch.kernels import flash_attention as fa

    c = paged_grad_case(torch, seed)
    q, k_pool, v_pool, page_list = c["q"], c["k_pool"], c["v_pool"], c["page_list"]
    call = c["call"]
    o, m, l = fa.flash_prefill_paged_forward(q, k_pool, v_pool, page_list,
                                             c["layout"], **call)
    res = (q, k_pool, v_pool, page_list, o, c["do"], m, l, c["layout"])
    ops_ = fa.prepare_backward(q, k_pool, v_pool, o, c["do"], m, l, None,
                               c["layout"], q_offset=0, block_k=k_pool.shape[2],
                               page_list=page_list, **call)
    dev, ev = timed(torch, [lambda: fa.flash_prefill_paged_backward(*res, **call)])
    return {"flash_bwd_dq_paged": device_ms(torch, [lambda: fa.launch_dq_paged(ops_)]),
            "flash_bwd_dkv_paged": device_ms(torch, [lambda: fa.launch_dkv_paged(ops_)]),
            "paged_backward_ms": dev, "paged_backward_call_ms": ev}


def paged_grad_phase(torch, seed: int) -> dict:
    """The trainable paged prefill's main path: one forward and backward
    through ``core.attention.paged_prefill_attention`` (impl "pallas") with
    q and both pools requiring grad. Launch counters are reset just before
    and the paged forward, dq, dkv and fold kernels must be > 0 just
    after."""
    from repro_torch.core.attention import AttentionSpec, paged_prefill_attention

    c = paged_grad_case(torch, seed + 1, requires_grad=True)
    torch.cuda.synchronize()
    reset_launches()
    o = paged_prefill_attention(c["q"], c["k_pool"], c["v_pool"],
                                c["page_list"], AttentionSpec(impl="pallas"),
                                **c["ids"])
    (o.float() * c["do"].float()).sum().backward()
    torch.cuda.synchronize()
    launches = read_launches()
    for name in PAGED_GRAD_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} was never launched in the paged-grad path")
    for name in PAGED_MMA_BODIES:
        check(launches[name] == 0,
              f"the paged-grad path launched the mma.sync body {name}")
    for n in ("q", "k_pool", "v_pool"):
        check(bool(torch.isfinite(c[n].grad).all()),
              f"paged-grad path: the {n} gradient is not finite")
    print(f"[paged-grad] forward + backward through paged_prefill_attention: "
          f"launches {launches}", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 3: float32 parity, cuda (kernels) vs cpu (plain versions)
# ---------------------------------------------------------------------------

def _serve(engine, prompts, n_new, prime: bool):
    if prime:
        engine.submit(prompts[0], max_new_tokens=n_new)
        engine.run()
        prompts = prompts[1:]
    for p in prompts:
        engine.submit(p, max_new_tokens=n_new)
    engine.run()
    return {r.rid: r.output for r in engine.finished}


@contextlib.contextmanager
def watch_routes():
    """While open, records every MoE layer call's top-k experts and router
    probabilities (copied to the CPU) in the yielded list:
    ``repro_torch.models.moe._route`` watched."""
    from repro_torch.models import moe
    seen, route = [], moe._route

    def watch(logits, k):
        out = route(logits, k)
        seen.append((out[0].cpu(), out[2].cpu()))
        return out

    moe._route = watch
    try:
        yield seen
    finally:
        moe._route = route


ROUTE_TIE = 1e-5      # a route flip is a near-tie below this probability gap


def route_differences(got, want, rows_apart: bool) -> tuple[list, bool]:
    """Compares two runs' MoE routes, call by call (the same calls in the
    same order; ``want`` is the CPU's). Every (row, token) whose top-k
    differs is a flip, with the gap of the CPU's router probabilities at
    the first differing rank. With ``rows_apart`` (a training forward:
    rows never mix) a row is followed until its first flip, and later
    calls' differences in it are its consequences; otherwise (a serve:
    caches carry a flip to every later call) only the first call with a
    difference is read. Returns (flips, whether each is a near-tie)."""
    flips, done = [], set()
    for c, ((gi, _), (wi, wp)) in enumerate(zip(got, want)):
        check(gi.shape == wi.shape, f"MoE call {c}: routes of shapes "
                                    f"{tuple(gi.shape)} and {tuple(wi.shape)}")
        new = [(b, t) for b, t in (gi != wi).any(-1).nonzero().tolist()
               if b not in done]
        for b, t in new:
            j = int((gi[b, t] != wi[b, t]).nonzero()[0])
            top = wp[b, t].sort(descending=True).values
            flips.append({"call": c, "row": b, "token": t, "rank": j,
                          "gap": float(top[j] - top[j + 1])})
        done |= {b for b, _ in new}
        if new and not rows_apart:
            break
    return flips, all(f["gap"] <= ROUTE_TIE for f in flips)


def parity_phase(torch, seed: int, arch: str = "granite-3-2b",
                 n_new: int = 12, tag: str = "parity") -> dict:
    """``arch`` at full width, 2 layers, float32: the same
    weights (drawn on the card from ``seed``) served by the paged engine on
    ``cuda`` (kernels) and on ``cpu`` (plain versions); greedy tokens must
    be identical, a divergence allowed only at a near-tie. For an MoE arch
    the routes of every MoE call are compared too (``route_differences``):
    a route flip is allowed only at a near-tie of the router (a gap of at
    most ``ROUTE_TIE`` in probability on the CPU's side), and then a token
    divergence after it is allowed as well; a route difference that is not
    a near-tie is allowed only after a token divergence at a near-tie of
    the logits (its consequence)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, params_to
    from repro_torch.serve import ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch), num_layers=2,
                              dtype="float32", attn_impl="pallas",
                              use_decode_kernel=True)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(seed),
                        device="cpu")
    gen = torch.Generator().manual_seed(seed + 1)

    def toks(n):
        return torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist()

    shared = toks(32)
    prompts = [shared + toks(9), toks(150), shared + toks(20), shared + toks(3),
               toks(40)]
    kw = dict(num_slots=4, capacity=256, page_size=16, chunk_size=64)
    outs, engines, routes = {}, {}, {}
    moe = cfg.family == "moe"
    for device in ("cuda", "cpu"):
        p = params if device == "cpu" else params_to(params, device)
        engines[device] = ServingEngine(model, p, device=device, **kw)
        t0 = time.perf_counter()
        with watch_routes() if moe else contextlib.nullcontext([]) as seen:
            outs[device] = _serve(engines[device], prompts, n_new, prime=True)
        routes[device] = seen
        print(f"[{tag}] {cfg.name} 2 layers float32, {device}: "
              f"{sum(map(len, outs[device].values()))} tokens in "
              f"{time.perf_counter() - t0:.2f}s", flush=True)
        del p
    check(engines["cuda"].prefix_hits >= 1, f"{tag} run had no prefix hit")
    diverged = []
    for rid, ref in outs["cpu"].items():
        got = outs["cuda"][rid]
        if got == ref:
            continue
        i = next(j for j, (a, c) in enumerate(zip(got, ref)) if a != c)
        ctx = prompts[rid] + ref[:i]
        with torch.inference_mode():
            _, logits = model.prefill_packed(params, {
                "tokens": torch.tensor([ctx]),
                "segment_ids": torch.zeros((1, len(ctx)), dtype=torch.int32)})
        top2 = torch.topk(logits[0, -1].float(), 2).values
        margin = float(top2[0] - top2[1])
        print(f"[{tag}] request {rid} diverges at generated step {i}: "
              f"cuda {got[i]} cpu {ref[i]}, top-2 logit margin {margin:.3g}",
              flush=True)
        diverged.append({"rid": rid, "step": i, "margin": margin})
    flips, near = route_differences(routes["cuda"], routes["cpu"],
                                    rows_apart=False)
    logit_ties = all(d["margin"] < 1e-3 for d in diverged)
    if moe:
        print(f"[{tag}] {len(routes['cpu'])} MoE calls; first call with a "
              f"route flip: {flips[0]['call'] if flips else None}, "
              f"{len(flips)} flips, gaps {[f['gap'] for f in flips]}",
              flush=True)
        check(near or (diverged and logit_ties),
              f"{tag}: a route flip that is not a near-tie ({flips})")
    for d in diverged:
        check(d["margin"] < 1e-3 or (flips and near),
              f"request {d['rid']} diverged at step {d['step']} with a "
              f"top-2 margin {d['margin']:.3g} (not a near-tie) and no "
              f"near-tie route flip before")
    print(f"[{tag}] greedy tokens identical: {not diverged} "
          f"({len(outs['cpu'])} requests, near-tie divergences: "
          f"{len(diverged)})", flush=True)
    rec = {"model": cfg.name, "layers": cfg.num_layers,
           "identical": not diverged, "near_tie_divergences": diverged,
           "requests": len(outs["cpu"]),
           "prefix_hits": engines["cuda"].prefix_hits}
    if moe:
        rec.update(moe_calls=len(routes["cpu"]), route_flips=flips)
    return rec


# ---------------------------------------------------------------------------
# phase 4: the published model, served through the kernels
# ---------------------------------------------------------------------------

def reset_launches():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    for table in (fa.LAUNCHES, fd.LAUNCHES):
        for k in table:
            table[k] = 0


def read_launches() -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    return {**fa.LAUNCHES, **fd.LAUNCHES}


# every bf16 forward at d 64 / 96 / 128 runs the wgmma/TMA body
# (flash_fwd_sm90.cu), and the contiguous bf16 pair at those head dims over
# 64 x 64 blocks flash_bwd_sm90.cu; the mma.sync counters stay 0 there
SERVE_KERNELS = ("flash_fwd_sm90", "flash_fwd_paged_sm90",
                 "flash_decode_paged")
DENSE_SERVE_KERNELS = ("flash_fwd_sm90", "flash_decode")
PAGED_GRAD_KERNELS = ("flash_fwd_paged_sm90", "flash_bwd_dq_paged_sm90",
                      "flash_bwd_dkv_paged_sm90", "flash_bwd_fold_paged")
# flash_bwd.cu's paged pair: the bf16 paged grad path at d 64 / 96 / 128
# with 64-row q blocks runs the sm90 pair; its records time the mma.sync
# pair forced beside it
PAGED_MMA_BODIES = ("flash_bwd_dq_paged", "flash_bwd_dkv_paged")
TRAIN_KERNELS = ("flash_fwd_sm90", "flash_bwd_dq_sm90", "flash_bwd_dkv_sm90")
# flash_bwd.cu's contiguous pair and flash_fwd.cu's bf16 forward: their
# records time the mma.sync body forced beside the sm90 one; no main path
# launches it (their launches must be 0)
MMA_BODY_NOTE = {
    "on_main_path": False,
    "body": "flash_bwd.cu's mma.sync body, forced (_mma_body) at the train "
            "shape beside the sm90 body; no main path launches it (fp32 "
            "calls, the parity runs', take its scalar instantiation)"}
MMA_BODIES = ("flash_fwd", "flash_fwd_paged", "flash_bwd_dq", "flash_bwd_dkv")
MMA_PAGED_NOTE = {
    "on_main_path": False,
    "body": "flash_bwd.cu's paged mma.sync pair, forced (_mma_body) at the "
            "paged grad shape beside the sm90 pair; no main path launches it "
            "(fp32 calls and q blocks below 64 rows take it)"}
MMA_FWD_NOTE = {
    "on_main_path": False,
    "body": "flash_fwd.cu's mma.sync body, forced (_mma_body) at the "
            "serving shape beside the sm90 body; no main path launches it "
            "(fp32 calls, the parity runs', take its scalar instantiation)"}
# the paths whose shapes time the mma.sync forward and backward beside the
# sm90 bodies: one per head dim (granite's train layer d 64, train-olmo's
# d 128, train-phi3v's d 96) and the shapes PERF.md's prediction for the
# sm90 forward names (seamless's layer and cross prefill, serve-qwen3's #1
# and #4, train-bert's layer; granite's serving calls in phase 2)
MMA_SHAPES = {"train", "train_bert", "train_olmo", "train_phi3v",
              "train_seamless", "serve_seamless", "serve_qwen3"}
# the later paths: (arch, seq, batch) of the two trained at full depth, and
# the depth serve-qwen3 cuts qwen3-32b to (its 64 layers hold ~65.5 GB of
# bf16 weights; 8 keep the published width at ~10.9 GB)
NEW_TRAIN_PATHS = {"train_bert": ("bert-large", 512, 56),
                   "train_olmo": ("olmo-1b", 2048, 4),
                   "train_hymba": ("hymba-1.5b", 2048, 4)}
SERVE_QWEN3_LAYERS = 8
# the MoE paths: olmoe-1b-7b is served at its full depth (16 layers, ~13.8
# GB of bf16 weights) and trained at 8 of its 16 layers (3.56 B parameters:
# bf16 params and grads and fp32 AdamW moments ~43 GB); phi3.5-moe's 32
# layers hold ~84 GB of bf16 weights, so it is served at 8 (~21.5 GB).
# train-olmoe's attention layer, (4, 16, 2048, 128) causal over the packed
# documents of SyntheticLM(50304, 2048, 4, seed), is train-olmo's.
SERVE_PHI35MOE_LAYERS = 8
TRAIN_OLMOE = ("olmoe-1b-7b", 2048, 4, 8)        # arch, seq, batch, layers
# the SSM and hybrid paths, at full width and depth: mamba2-2.7b (64
# layers, 2.70 B parameters) and hymba-1.5b (32 layers, 1.6 B). The SSM
# layer is held at train-mamba2's tokens; train-hymba's attention layer,
# (4, 25/5, 2048, 64) causal with a window of 1024 over the packed
# documents of SyntheticLM(32001, 2048, 4, seed), is in NEW_TRAIN_PATHS.
SSM_LAYER = ("mamba2-2.7b", 2048, 4)             # arch, seq, batch
# float32 card-vs-CPU parity of the two at 2 layers: (seq, batch) of the
# loss and its gradients, prompt lengths (some not a chunk multiple; for
# hymba one past its window of 1024) and slot capacity of the dense serve
RECURRENT_PARITY = {
    "mamba2-2.7b": ((512, 2), (41, 300, 7, 96, 600), 640),
    "hymba-1.5b": ((1280, 1), (41, 300, 7, 96, 1100), 1152)}
# serve-hymba's and serve-mamba2's longest prompt: 1536 tokens, so that
# hymba's window skips whole tiles in its prefill and decode
RECURRENT_LONG_PROMPT = 1536


def serve_phase(torch, seed: int, card: str, arch: str = "granite-3-2b",
                num_layers: int | None = None, tag: str = "serve",
                hold_shapes: bool = False) -> tuple[dict, dict]:
    """``arch`` at its published width (and depth, unless ``num_layers``),
    bf16, random weights drawn on the card from ``seed``, served by the
    paged engine through the kernels; then profiled (``profile_serve``).
    With ``hold_shapes`` the same requests are served once more with the
    serving kernels' wrappers watched (``capture_calls``), and each
    kernel's call that did the most work is returned under
    ``rec["calls"]``, for ``serve_shape_records_apart`` to hold the kernels
    there."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import ServingEngine

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(arch), attn_impl="pallas",
                              use_decode_kernel=True)
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(seed),
                        device=dev)
    torch.cuda.synchronize()
    print(f"[{tag}] {cfg.name}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
          f"{cfg.head_dim}, {cfg.dtype}, weights in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    gen = torch.Generator().manual_seed(seed + 2)

    def toks(n):
        return torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist()

    kw = dict(num_slots=4, capacity=1056, page_size=16, chunk_size=256,
              device=dev)
    warm = ServingEngine(model, params, **kw)       # cuBLAS / allocator warm-up
    warm.submit(toks(300), max_new_tokens=4)
    warm.run()
    del warm

    shared = toks(64)
    prompts = [shared + toks(1024 - 64)] + [shared + toks(n) for n in
                                            (17, 120, 45, 200, 9, 77, 150)]
    eng = ServingEngine(model, params, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    t0 = time.perf_counter()
    for p in prompts:
        eng.submit(p, max_new_tokens=32)
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated(dev)
    n_tok = sum(len(r.output) for r in done)
    lat = eng.latency_stats()
    check(len(done) == len(prompts) and all(len(r.output) == 32 for r in done),
          f"{tag} phase did not finish every request")
    check(eng.prefix_hits >= 1, f"{tag} phase had no prefix-cache hit")
    for name in SERVE_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} was never launched in the {tag} phase")
    ledger = ledger_record(eng, tag, card)
    profile = profile_serve(torch, model, params, prompts, kw)
    rec = {"model": cfg.name, "layers": cfg.num_layers, "dtype": cfg.dtype,
           "requests": len(done), "lanes": 4, "new_tokens": n_tok,
           "wall_s": wall, "tokens_per_s": n_tok / wall,
           "ttft_p50_s": lat["ttft_p50"], "ttft_p95_s": lat["ttft_p95"],
           "tok_latency_p50_s": lat["tok_latency_p50"],
           "peak_memory_bytes": peak, "prefix_hits": eng.prefix_hits,
           "prefill_calls": eng.prefill_calls,
           "decode_calls": eng.decode_calls, "profile": profile,
           "ledger": ledger, "card": card}
    print(f"[{tag}] {n_tok} tokens in {wall:.2f}s: {n_tok / wall:.1f} tok/s, "
          f"TTFT p50 {lat['ttft_p50'] * 1e3:.1f} ms, peak memory "
          f"{peak / 2**30:.2f} GiB, prefix hits {eng.prefix_hits}, "
          f"launches {launches} [{card}]", flush=True)
    if hold_shapes:
        rec["calls"] = capture_calls(torch, lambda: _serve(
            ServingEngine(model, params, **kw), prompts, 32, prime=False))
    return rec, launches


def ledger_record(eng, tag: str, card: str) -> dict:
    """The engine's IO ledger after a serve (``engine.tm.ledger``): per
    step kind, the steps, the predicted HBM bytes (``io_model``, at the
    forward kernel's tiles), the wall time of the steps (host clock, each
    ending at the sampled tokens' read-back) and the implied GB/s, with
    its share of the card's 3.35 TB/s. Printed as the ledger's table."""
    summary = eng.tm.ledger.summary()
    for kind, c in summary.items():
        c["share_of_hbm_bw"] = (c["implied_gb_per_s"] * 1e9 / HBM_BYTES_PER_S
                                if kind != "prefix_saved" else None)
    print(f"[{tag}] IO ledger (predicted HBM bytes against the steps' wall "
          f"time; the card's HBM moves {HBM_BYTES_PER_S / 1e9:.0f} GB/s) "
          f"[{card}]:", flush=True)
    for line in eng.tm.ledger.table().splitlines():
        print(f"[{tag}]   {line}", flush=True)
    print(f"[{tag}] implied share of the HBM rate by step kind: "
          + ", ".join(f"{k} {c['share_of_hbm_bw']:.2%}"
                      for k, c in summary.items()
                      if c["share_of_hbm_bw"] is not None), flush=True)
    return summary


# the serving kernels' wrappers as the engine calls them, each with the
# work of one call (q rows times the key rows it may read)
SERVE_WRAPPERS = {
    "flash_fwd": ("flash_attention", "flash_attention_forward",
                  lambda a: a[0].shape[0] * a[0].shape[2] * a[1].shape[2]),
    "flash_fwd_paged": ("flash_attention", "flash_prefill_paged_forward",
                        lambda a: a[0].shape[2] * int((a[3] >= 0).sum())),
    "flash_decode_paged": ("flash_decode", "flash_decode_paged_from_layout",
                           lambda a: int(a[4].sum()))}
# the dense-slot serve's: the unpadded prefill's forward and the
# contiguous decode
DENSE_SERVE_WRAPPERS = {
    "flash_fwd": SERVE_WRAPPERS["flash_fwd"],
    "flash_decode": ("flash_decode", "flash_decode_from_layout",
                     lambda a: int(a[3].sum()))}


def capture_calls(torch, run, wrappers=SERVE_WRAPPERS) -> dict:
    """Runs ``run()`` with each wrapper of ``wrappers`` replaced by
    one that calls it and keeps the arguments of its call with the most
    work (the first of equals): q, K and V as meta tensors of their shape
    and dtype, every other tensor cloned. Returns {kernel: (args, kw)};
    the wrappers are put back however ``run`` ends. The extra host work
    (and a sync a call for the work of the paged calls) is why this runs
    beside the timed serve, not in it."""
    import importlib

    def keep(i, x):
        if not isinstance(x, torch.Tensor):
            return x
        if i < 3:
            return torch.empty(x.shape, dtype=x.dtype, device="meta")
        return x.clone()

    best, saved = {}, {}

    def watch(name, fn, work):
        def call(*a, **kw):
            w = work(a)
            if name not in best or w > best[name][0]:
                best[name] = (w, tuple(keep(i, x) for i, x in enumerate(a)),
                              {n: keep(3, x) for n, x in kw.items()})
            return fn(*a, **kw)
        return call

    for name, (mod, attr, work) in wrappers.items():
        mod = importlib.import_module(f"repro_torch.kernels.{mod}")
        saved[name] = (mod, attr, getattr(mod, attr))
        setattr(mod, attr, watch(name, saved[name][2], work))
    try:
        run()
    finally:
        for mod, attr, fn in saved.values():
            setattr(mod, attr, fn)
    check(set(best) == set(wrappers),
          f"the serve called only {sorted(best)} of {sorted(wrappers)}")
    return {name: (a, kw) for name, (_, a, kw) in best.items()}


def serve_shape_records(torch, seed: int, calls: dict, tag: str) -> dict:
    """Each kernel of ``calls`` (#1, and #4 and #8 of a paged serve or #7
    of a dense one) held against its plain version at the call the serve
    gave it (``capture_calls``), with random q, K and V of those shapes,
    timed beside its bound and SDPA's time. Returns {kernel: entry},
    entries without ``launches`` (``main`` adds the path's)."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 30)

    def inputs(name):
        args, kw = calls[name]
        return tuple(fresh(torch, gen, t) for t in args[:3]) + args[3:], kw

    def segments(ids) -> list[int]:
        if ids is None:                # an unpacked prefill: one segment
            return [calls["flash_fwd"][0][0].shape[2]]
        return ids[0].unique_consecutive(return_counts=True)[1].tolist()

    out = {}
    with torch.inference_mode():        # the engine's tensors were made so
        if "flash_fwd" in calls:        # none at sp > 1 (chunk steps only)
            args, kw = inputs("flash_fwd")
            b, hq, sq, d = args[0].shape
            out["flash_fwd_sm90"] = packed_prefill_record(
                torch, gen, args, kw,
                f"{tag} {'packed ' if kw['q_segment_ids'] is not None else ''}"
                f"prefill b={b} hq={hq} hkv={args[1].shape[1]} "
                f"S={sq} d={d}, {'causal' if kw['causal'] else 'non-causal'}, "
                f"window {kw['window']}, rows by segment "
                f"{segments(kw['q_segment_ids'])}",
                mma=tag.replace("-", "_") in MMA_SHAPES)
        if "flash_decode" in calls:
            args, kw = inputs("flash_decode")
            dec = contiguous_decode_record_at(torch, gen, args, kw)
            dec["shape"] = f"{tag} {dec['shape']}"
            out["flash_decode"] = dec
            return _without_launches(out)
        args, kw = inputs("flash_fwd_paged")
        b, hq, sq, d = args[0].shape
        hkv, _, ps, _ = args[1].shape
        out["flash_fwd_paged_sm90"] = paged_prefill_record(
            torch, gen, args, kw,
            f"{tag} chunked prefill hq={hq} hkv={hkv} d={d}: {sq} q rows "
            f"(by segment {segments(kw['q_segment_ids'])}, first position "
            f"{int(kw['q_positions'][0, 0])}) against "
            f"{int((args[3] >= 0).sum())} live of {args[3].shape[1]} pages "
            f"of {ps}", mma=tag.replace("-", "_") in MMA_SHAPES)
        args, kw = inputs("flash_decode_paged")
        dec = paged_decode_record(torch, gen, args, kw)
        dec["shape"] = f"{tag} {dec['shape']}"
        out["flash_decode_paged"] = dec
    return _without_launches(out)


def _without_launches(out: dict) -> dict:
    for entry in out.values():
        entry.pop("launches")
    return out


_SHAPES_RUN = """
import json, sys
sys.path[:0] = [{src!r}, {here!r}]
import torch
import chip_smoke as cs
cs.use_io_model()
saved = torch.load({path!r}, map_location="cuda", weights_only=False)


def back(x):
    if isinstance(x, tuple) and x[:1] == ("meta",):
        return torch.empty(x[1], dtype=getattr(torch, x[2]), device="meta")
    return x


out = {{path: cs.serve_shape_records(
    torch, saved["seed"],
    {{n: (tuple(map(back, a)), kw) for n, (a, kw) in calls.items()}}, tag)
    for path, (tag, calls) in saved["paths"].items()}}
print("SHAPES " + json.dumps(out))
"""


def serve_shape_records_apart(torch, seed: int, paths: dict) -> dict:
    """``serve_shape_records`` of each serve path, {path: (tag, calls)},
    in one fresh Python process on the same card; returns {path: {kernel:
    entry}}. Late in this script's long process ``torch.profiler`` stops
    recording whole windows (after serve-qwen3's serve it recorded none of
    these kernels' windows whole in ten tries), where a fresh process
    records them at once. The captured calls go through a file under
    ``build/``, q, K and V as ("meta", shape, dtype)."""
    def put(x):
        if not isinstance(x, torch.Tensor):
            return x
        if x.device.type == "meta":
            return ("meta", tuple(x.shape), str(x.dtype).removeprefix("torch."))
        return x.cpu()

    path = ROOT / "build" / "serve_shape_calls.pt"
    torch.save({"seed": seed, "paths": {
        p: (tag, {n: (tuple(map(put, a)), {k: put(v) for k, v in kw.items()})
                  for n, (a, kw) in calls.items()})
        for p, (tag, calls) in paths.items()}}, path)
    code = _SHAPES_RUN.format(src=str(ROOT / "src"), here=str(ROOT),
                              path=str(path))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    lines = out.stdout.splitlines()
    for x in lines:
        if not x.startswith("SHAPES "):
            print(x, flush=True)
    line = [x for x in lines if x.startswith("SHAPES ")]
    check(out.returncode == 0 and len(line) == 1,
          f"the serves' shape records failed: {out.stderr[-3000:]}")
    return json.loads(line[0][len("SHAPES "):])


def _device_us(e) -> float:
    return e.self_device_time_total


# the layer functions whose calls ``layer_ranges`` marks, by range name
RANGED = {"moe": ("moe", ("apply_moe",)),
          "ssm": ("ssm", ("apply_ssm", "decode_ssm_step"))}


def ranged_layer(block: dict) -> str | None:
    """The range ``layer_ranges`` marks in a model of these blocks: "moe",
    "ssm" (SSM and hybrid blocks) or None."""
    return next((name for name in RANGED if name in block), None)


@contextlib.contextmanager
def layer_ranges(torch, name: str | None):
    """While open, every call of the ``RANGED[name]`` layer functions
    (``repro_torch.models.<module>.<fn>``, wrapped) runs inside a
    ``torch.profiler`` range named ``name``; nothing for None."""
    import importlib
    if name is None:
        yield
        return
    mod_name, fns = RANGED[name]
    mod = importlib.import_module(f"repro_torch.models.{mod_name}")
    saved = {fn: getattr(mod, fn) for fn in fns}

    def wrap(fn):
        def ranged(*a, **kw):
            with torch.profiler.record_function(name):
                return fn(*a, **kw)
        return ranged

    for fn, f in saved.items():
        setattr(mod, fn, wrap(f))
    try:
        yield
    finally:
        for fn, f in saved.items():
            setattr(mod, fn, f)


@dataclasses.dataclass
class DeviceKernel:
    """One device kernel of a profile: its name, launches and device µs."""
    key: str
    count: int = 0
    self_device_time_total: float = 0.0


def _raw_events(prof) -> list:
    """The profile's raw events (``_KinetoEvent``s: name, device type,
    start and end in ns, correlation id, thread). Read these, not
    ``prof.events()``: building that event tree took ~40 s of a profiled
    serve's post-processing on the card (serve-mamba2), and
    ``key_averages()`` over it another ~20-40 s."""
    return prof.profiler.kineto_results.events()


def _is_kernel(e) -> bool:
    """A device event that is work (a kernel, a copy, a memset), not a
    device-side copy of a host range."""
    from torch.autograd import DeviceType
    return (e.device_type() == DeviceType.CUDA and not e.is_user_annotation()
            and not e.is_hidden_event() and e.name() not in RANGED)


def device_kernels(prof) -> list[DeviceKernel]:
    """The device kernels of a profile by name (launches, device µs), as
    ``key_averages()`` sums them, without the profiler's device-side
    copies of ``layer_ranges``' ranges."""
    out: dict[str, DeviceKernel] = {}
    for e in _raw_events(prof):
        if _is_kernel(e):
            k = out.setdefault(e.name(), DeviceKernel(e.name()))
            k.count += 1
            k.self_device_time_total += (e.end_ns() - e.start_ns()) / 1e3
    return list(out.values())


def range_share(prof, busy_us: float, name: str) -> dict:
    """Device time of the kernels launched inside ``layer_ranges``' ranges
    ``name`` (the layer forwards, with remat their recomputation too; a
    backward's kernels are launched outside them), and its share of the
    device's busy time. A kernel belongs to the host op that launched it
    (the op whose id is its linked correlation id, as the profiler links
    them) and so to a range ``name`` that spans that op on its thread."""
    import bisect

    from torch.autograd import DeviceType
    events = _raw_events(prof)
    spans: dict[int, list] = {}
    ops = {}
    for e in events:
        if e.device_type() != DeviceType.CPU or e.linked_correlation_id():
            continue
        if e.name() == name:
            spans.setdefault(e.start_thread_id(), []).append(
                (e.start_ns(), e.end_ns()))
        ops[e.correlation_id()] = (e.start_thread_id(), e.start_ns())
    for v in spans.values():
        v.sort()
    starts = {t: [a for a, _ in v] for t, v in spans.items()}
    ns = 0
    for e in events:
        op = ops.get(e.linked_correlation_id()) if _is_kernel(e) else None
        if op is None or op[0] not in spans:
            continue
        i = bisect.bisect_right(starts[op[0]], op[1]) - 1
        if i >= 0 and op[1] <= spans[op[0]][i][1]:
            ns += e.end_ns() - e.start_ns()
    us = ns / 1e3
    return {f"{name}_device_s": us / 1e6,
            f"{name}_share_of_busy": us / busy_us if us > 0 else None}


PROFILED_NEW_TOKENS = 8


def profile_serve(torch, model, params, prompts, kw) -> dict:
    """The same requests once more under ``torch.profiler`` with
    ``PROFILED_NEW_TOKENS`` new tokens each instead of 32 (tracing multiplies
    the host cost of every decode step; the prefill work is the same): device
    busy share of the wall time, device time per launch of each ported
    kernel, and the kernels that take the most device time. Launch counters
    are not read here."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import ServingEngine

    eng = ServingEngine(model, params, **kw)
    for p in prompts:
        eng.submit(p, max_new_tokens=PROFILED_NEW_TOKENS)
    ranged = ranged_layer(params["blocks"][0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            layer_ranges(torch, ranged):
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = device_kernels(prof)
    busy_us = sum(_device_us(e) for e in kernels)
    if busy_us <= 0:
        print("[profile] the profiler recorded no device time: not measured",
              flush=True)
        return {"busy_share": None}
    # flash_fwd_sm90_kernel<D, Paged, Dropout, Paper>,
    # flash_fwd_kernel<T, D, Paged, Dropout, Paper> and
    # flash_decode_kernel<T, D, Paged>: Paged tells them apart
    ported = {"flash_fwd_sm90": r"flash_fwd_sm90_kernel<\d+, false",
              "flash_fwd_paged_sm90": r"flash_fwd_sm90_kernel<\d+, true",
              "flash_fwd": r"flash_fwd_kernel(?:_min)?<[^,>]+, \d+, false",
              "flash_fwd_paged": r"flash_fwd_kernel(?:_min)?<[^,>]+, \d+, true",
              "flash_decode_paged":
                  r"flash_decode_kernel(?:_min)?<[^,>]+, \d+, true>",
              "flash_decode": r"flash_decode_kernel(?:_min)?<[^,>]+, \d+, false>"}
    per_kernel = {}
    for name, pattern in ported.items():
        hits = [e for e in kernels if re.search(pattern, e.key)]
        n = sum(e.count for e in hits)
        per_kernel[name] = {
            "launches": n, "device_ms_total": sum(_device_us(e) for e in hits) / 1e3,
            "device_ms_per_launch": (sum(_device_us(e) for e in hits) / 1e3 / n
                                     if n else None)}
    top = sorted(kernels, key=_device_us, reverse=True)[:8]
    out = {"wall_s": wall_us / 1e6, "device_busy_s": busy_us / 1e6,
           "busy_share": busy_us / wall_us, "ported": per_kernel,
           "new_tokens_per_request": PROFILED_NEW_TOKENS,
           "top": [{"kernel": e.key[:90], "count": e.count,
                    "device_ms": _device_us(e) / 1e3} for e in top]}
    if ranged:
        out.update(range_share(prof, busy_us, ranged))
    print(f"[profile] serve under torch.profiler: wall {wall_us / 1e6:.2f}s, "
          f"device busy {busy_us / 1e6:.3f}s ({busy_us / wall_us:.1%}); "
          f"ported kernels {json.dumps(per_kernel)}"
          + (f"; {ranged} layers {out[ranged + '_device_s']:.3f}s of the busy "
             f"time ({out[ranged + '_share_of_busy']})" if ranged else ""),
          flush=True)
    for t in out["top"]:
        print(f"[profile]   {t['device_ms']:9.2f} ms  x{t['count']:<6} "
              f"{t['kernel']}", flush=True)
    return out


# ---------------------------------------------------------------------------
# phases 4b-4c: dense slot serving
# ---------------------------------------------------------------------------

def dense_parity_phase(torch, seed: int) -> dict:
    """granite-3-2b at full width, 2 layers, float32, dense slot mode: the
    engine on ``cuda`` (packed prefill + the contiguous decode kernel)
    against the same engine on ``cpu`` (plain versions), and against the
    paged engine on ``cuda``; greedy tokens must be identical."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, params_to
    from repro_torch.serve import ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config("granite-3-2b"), num_layers=2,
                              dtype="float32", attn_impl="pallas",
                              use_decode_kernel=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(seed + 4), device="cpu")
    gen = torch.Generator().manual_seed(seed + 5)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in (41, 150, 7, 96, 23)]
    outs, launches = {}, {}
    for device, paged in (("cuda", False), ("cpu", False), ("cuda", True)):
        eng = ServingEngine(model, params_to(params, device), device=device,
                            num_slots=4, capacity=256, paged=paged)
        reset_launches()
        t0 = time.perf_counter()
        outs[(device, paged)] = _serve(eng, prompts, 12, prime=False)
        launches[(device, paged)] = read_launches()
        print(f"[dense-parity] {device} {'paged' if paged else 'dense'}: "
              f"{sum(map(len, outs[(device, paged)].values()))} tokens in "
              f"{time.perf_counter() - t0:.2f}s", flush=True)
    check(launches[("cuda", False)]["flash_decode"] > 0
          and launches[("cuda", False)]["flash_decode_paged"] == 0,
          "dense parity: the dense engine did not decode through flash_decode")
    vs_cpu = outs[("cuda", False)] == outs[("cpu", False)]
    vs_paged = outs[("cuda", False)] == outs[("cuda", True)]
    print(f"[dense-parity] greedy tokens identical: cuda dense vs cpu dense "
          f"{vs_cpu}, cuda dense vs cuda paged {vs_paged}", flush=True)
    check(vs_cpu, "dense parity: cuda and cpu tokens differ")
    check(vs_paged, "dense parity: dense and paged tokens differ on the card")
    return {"identical_vs_cpu": vs_cpu, "identical_vs_paged": vs_paged,
            "requests": len(prompts)}


def dense_serve_phase(torch, seed: int, card: str,
                      arch: str = "granite-3-2b", tag: str = "dense-serve",
                      long_prompt: int = 1024,
                      kernels=DENSE_SERVE_KERNELS,
                      profiled: bool = False) -> tuple[dict, dict]:
    """The published ``arch`` (bf16, full depth) in dense slot mode with
    the decode kernel: 4 slots of 2048, 8 requests with prompts of
    64-``long_prompt`` tokens, 32 new tokens each (granite's drained
    requests prefilled packed; the SSM and hybrid families prefill each
    unpadded). Launch counters reset just before; every kernel of
    ``kernels`` must be > 0 just after, and every other kernel 0. With
    ``profiled`` the same requests run once more under ``torch.profiler``
    (``profile_serve``), and once more with the wrappers of #1 and #7
    watched (``capture_calls``), each call with the most work returned
    under ``rec["calls"]`` where ``kernels`` is not empty."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import ServingEngine

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(arch), attn_impl="pallas",
                              use_decode_kernel=True)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(seed),
                        device=dev)
    gen = torch.Generator().manual_seed(seed + 6)

    def toks(n):
        return torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist()

    kw = dict(num_slots=4, capacity=2048, paged=False, device=dev)
    warm = ServingEngine(model, params, **kw)       # cuBLAS / allocator warm-up
    warm.submit(toks(300), max_new_tokens=4)
    warm.run()
    del warm
    prompts = [toks(n) for n in (64, long_prompt, 300, 512, 128, 900, 700,
                                 200)]
    eng = ServingEngine(model, params, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    t0 = time.perf_counter()
    for p in prompts:
        eng.submit(p, max_new_tokens=32)
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated(dev)
    n_tok = sum(len(r.output) for r in done)
    lat = eng.latency_stats()
    check(len(done) == len(prompts) and all(len(r.output) == 32 for r in done),
          f"{tag} phase did not finish every request")
    check(not eng.paged, f"{tag}: the engine is not in dense slot mode")
    for name, n in launches.items():
        check((n > 0) == (name in kernels),
              f"kernel {name} was launched {n} times in the {tag} phase "
              f"(expected: {kernels} only)")
    rec = {"model": cfg.name, "layers": cfg.num_layers, "dtype": cfg.dtype,
           "mode": "dense slots", "requests": len(done), "lanes": 4,
           "capacity": 2048, "prompt_lens": [len(p) for p in prompts],
           "new_tokens": n_tok, "wall_s": wall,
           "tokens_per_s": n_tok / wall, "ttft_p50_s": lat["ttft_p50"],
           "ttft_p95_s": lat["ttft_p95"],
           "tok_latency_p50_s": lat["tok_latency_p50"],
           "peak_memory_bytes": peak, "prefill_calls": eng.prefill_calls,
           "decode_calls": eng.decode_calls,
           "decode_geometry": [eng.decode_block_k, eng.num_decode_splits],
           "blocks_skipped": eng.blocks_skipped,
           "blocks_total": eng.blocks_total,
           "state_bytes": eng.per_shard_cache_bytes(), "card": card}
    print(f"[{tag}] {cfg.name} {cfg.num_layers} layers: {n_tok} tokens in "
          f"{wall:.2f}s: {n_tok / wall:.1f} tok/s, TTFT p50 "
          f"{lat['ttft_p50'] * 1e3:.1f} ms (p95 {lat['ttft_p95'] * 1e3:.1f}), "
          f"decode step p50 {lat['tok_latency_p50'] * 1e3:.1f} ms, peak memory "
          f"{peak / 2**30:.2f} GiB, slot state "
          f"{eng.per_shard_cache_bytes() / 2**30:.3f} GiB, prefill calls {eng.prefill_calls}, launches {launches} "
          f"[{card}]", flush=True)
    if profiled:
        rec["profile"] = profile_serve(torch, model, params, prompts, kw)
        if kernels:                 # #1 and #7 (none in an SSM serve)
            rec["calls"] = capture_calls(torch, lambda: _serve(
                ServingEngine(model, params, **kw), prompts, 32, prime=False),
                DENSE_SERVE_WRAPPERS)
    return rec, launches


# ---------------------------------------------------------------------------
# phase 5: float32 train parity, cuda (kernels) vs cpu (plain versions)
# ---------------------------------------------------------------------------

def _grads(torch, model, params, batch):
    """(loss, grads) of one batch, grads in the params' tree layout."""
    from repro_torch.core.tree import tree_leaves, with_leaves
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss, _ = model.loss(with_leaves(params, leaves), batch,
                         deterministic=True)
    return float(loss.detach()), with_leaves(
        params, torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True))


def adamw_recipe():
    """The training launcher's recipe at two steps."""
    from repro_torch.optim import adamw, warmup_cosine
    return adamw(warmup_cosine(3e-4, 20, 2))


def lamb_recipe():
    """The MLPerf-BERT recipe (``benchmarks/bench_table1_bert.py``)."""
    from repro_torch.optim import lamb, warmup_poly
    return lamb(warmup_poly(3.75e-3, 10, 7100))


def train_parity_phase(torch, seed: int, arch: str = "granite-3-2b",
                       recipe=adamw_recipe, tag: str = "train-parity") -> dict:
    """``arch`` at full width, 2 layers, float32, seq 512, batch 2: the same
    weights (drawn on the card from ``seed``) and ``SyntheticLM`` batches
    through two train steps of ``recipe()`` on ``cuda`` (kernels) and on
    ``cpu`` (plain versions)."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model, params_to
    from repro_torch.train import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch), num_layers=2,
                              dtype="float32", attn_impl="pallas")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(seed),
                        device="cpu")
    data = SyntheticLM(cfg.vocab_size, 512, 2, seed=seed + 3)
    out = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        if device == "cuda":
            torch.cuda.synchronize()
            reset_launches()
        p = params_to(params, device)
        _, g = _grads(torch, model, p, data.batch_at(0))
        g0 = {n: g["blocks"][0]["attn"][n].cpu() for n in ("wq", "wk", "wv")}
        del g
        opt = recipe()
        state = opt.init(p)
        step = make_train_step(model, opt, clip_norm=1.0, deterministic=True)
        losses = []
        for s in range(2):
            p, state, metrics = step(p, state, data.batch_at(s))
            losses.append(float(metrics["loss"]))
        out[device] = {"losses": losses, "grads": g0}
        if device == "cuda":
            torch.cuda.synchronize()
            out["launches"] = read_launches()
        del p, state
        print(f"[{tag}] {cfg.name} 2 layers float32, {device}: losses "
              f"{losses} in {time.perf_counter() - t0:.1f}s", flush=True)
    rel = [abs(a - b) / abs(b) for a, b in zip(out["cuda"]["losses"],
                                               out["cpu"]["losses"])]
    gerr = {n: scaled_err(out["cuda"]["grads"][n], out["cpu"]["grads"][n])
            for n in ("wq", "wk", "wv")}
    print(f"[{tag}] loss relative differences {rel}; layer-0 "
          f"scaled grad differences {gerr}", flush=True)
    check(max(rel) <= 1e-4, f"{tag}: losses differ by {rel} > 1e-4")
    check(max(gerr.values()) <= 1e-3,
          f"{tag}: layer-0 grads differ by {gerr} > 1e-3")
    # float32 runs flash_bwd.cu's scalar body (the card's parity mode)
    check(out["launches"]["flash_bwd_dq"] > 0 and out["launches"]["flash_bwd_dkv"] > 0
          and out["launches"]["flash_bwd_dq_sm90"] == 0,
          f"{tag}: float32 launches {out['launches']}")
    return {"model": cfg.name, "losses_cuda": out["cuda"]["losses"],
            "losses_cpu": out["cpu"]["losses"], "loss_rel_diff": rel,
            "grad_scaled_diff": gerr, "launches": out["launches"]}


MOE_GRADS = (("attn", "wq"), ("attn", "wk"), ("attn", "wv"),
             ("moe", "router"), ("moe", "w_gate"), ("moe", "w_up"),
             ("moe", "w_down"))


def moe_train_parity_phase(torch, seed: int, arch: str, tag: str) -> dict:
    """The MoE ``arch`` at full width, 2 layers, float32, remat on: the
    same weights (drawn on the card from ``seed``) and one packed
    ``SyntheticLM`` batch (seq 256, batch 2) through the loss and its
    gradients on ``cuda`` (kernels) and on ``cpu`` (plain versions), each
    MoE call's routes watched. Every route flip must be a near-tie
    (``route_differences``, rows apart); the rows with one are then left
    out and the loss and gradients taken again on the others. The loss
    within 1e-4 relative; layer 0's attention and MoE gradients (router
    included) within 1e-3 scaled by their max."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model, params_to

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch), num_layers=2,
                              dtype="float32", attn_impl="pallas")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(seed),
                        device="cpu")
    batch = SyntheticLM(cfg.vocab_size, 256, 2, seed=seed + 3).batch_at(0)

    def run(rows=None):
        b = batch if rows is None else {k: v[rows] for k, v in batch.items()}
        out = {}
        for device in ("cuda", "cpu"):
            t0 = time.perf_counter()
            p = params_to(params, device)
            with watch_routes() as seen:
                loss, g = _grads(torch, model, p, b)
            out[device] = {"loss": loss, "routes": seen, "grads": {
                n: g["blocks"][0][m][n].cpu() for m, n in MOE_GRADS}}
            del p, g
            print(f"[{tag}] {cfg.name} 2 layers float32, {device}: loss "
                  f"{loss} in {time.perf_counter() - t0:.1f}s", flush=True)
        return out

    out = run()
    flips, near = route_differences(out["cuda"]["routes"],
                                    out["cpu"]["routes"], rows_apart=True)
    print(f"[{tag}] {len(out['cpu']['routes'])} MoE calls, route flips "
          f"{flips}", flush=True)
    check(near, f"{tag}: a route flip that is not a near-tie ({flips})")
    rows = None
    if flips:
        rows = [r for r in range(2) if r not in {f["row"] for f in flips}]
        check(bool(rows), f"{tag}: every row has a route flip")
        out = run(rows)
    rel = abs(out["cuda"]["loss"] - out["cpu"]["loss"]) / abs(out["cpu"]["loss"])
    gerr = {n: scaled_err(out["cuda"]["grads"][n], out["cpu"]["grads"][n])
            for _, n in MOE_GRADS}
    print(f"[{tag}] loss relative difference {rel:.3g} (rows "
          f"{rows or 'all'}); layer-0 scaled grad differences {gerr}",
          flush=True)
    check(rel <= 1e-4, f"{tag}: losses differ by {rel} > 1e-4")
    check(max(gerr.values()) <= 1e-3,
          f"{tag}: layer-0 grads differ by {gerr} > 1e-3")
    return {"model": cfg.name, "loss_cuda": out["cuda"]["loss"],
            "loss_cpu": out["cpu"]["loss"], "loss_rel_diff": rel,
            "grad_scaled_diff": gerr, "route_flips": flips,
            "rows_compared": rows or [0, 1],
            "moe_calls": len(out["cpu"]["routes"])}


def recurrent_parity_phase(torch, seed: int, arch: str, tag: str) -> dict:
    """The SSM or hybrid ``arch`` at full width, 2 layers, float32: the
    same weights (drawn on the card from ``seed``) on ``cuda`` (kernels)
    and on ``cpu`` (plain versions). The loss of one packed ``SyntheticLM``
    batch (``RECURRENT_PARITY``) within 1e-4 relative and every layer-0
    gradient within 1e-4 scaled by its max (the hybrid's ``ssm_norm``,
    which the loss never reads, exactly zero on both); then the dense-slot
    engine (the family's default) serving the same prompts, greedy tokens
    identical, a divergence allowed only at a near-tie of the CPU's logits
    (top-2 margin < 1e-3)."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model, params_to
    from repro_torch.serve import ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch), num_layers=2,
                              dtype="float32", attn_impl="pallas",
                              use_decode_kernel=True)
    (seq, b), lens, capacity = RECURRENT_PARITY[arch]
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(seed),
                        device="cpu")
    batch = SyntheticLM(cfg.vocab_size, seq, b, seed=seed + 3).batch_at(0)
    gen = torch.Generator().manual_seed(seed + 7)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in lens]
    out, launches = {}, {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        p = params_to(params, device)
        loss, g = _grads(torch, model, p, batch)
        grads = {f"{k}/{n}": t.cpu() for k, v in g["blocks"][0].items()
                 for n, t in v.items()}
        del g
        eng = ServingEngine(model, p, device=device, num_slots=4,
                            capacity=capacity)
        check(not eng.paged, f"{tag}: the engine did not choose dense slots")
        reset_launches()
        toks = _serve(eng, prompts, 8, prime=False)
        launches[device] = read_launches()
        out[device] = {"loss": loss, "grads": grads, "tokens": toks}
        del p, eng
        print(f"[{tag}] {cfg.name} 2 layers float32, {device}: loss {loss}, "
              f"{sum(map(len, toks.values()))} tokens in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
    rel = abs(out["cuda"]["loss"] - out["cpu"]["loss"]) / abs(out["cpu"]["loss"])
    gerr = {n: scaled_err(out["cuda"]["grads"][n], out["cpu"]["grads"][n])
            for n in out["cpu"]["grads"]
            if float(out["cpu"]["grads"][n].abs().max()) > 0}
    zero = sorted(set(out["cpu"]["grads"]) - set(gerr))
    print(f"[{tag}] loss relative difference {rel:.3g}; layer-0 scaled grad "
          f"differences {gerr}; zero on the CPU: {zero}", flush=True)
    check(rel <= 1e-4, f"{tag}: losses differ by {rel} > 1e-4")
    check(max(gerr.values()) <= 1e-4,
          f"{tag}: layer-0 grads differ by {gerr} > 1e-4")
    check(zero == (["ssm_norm/w"] if cfg.hybrid else []),
          f"{tag}: layer-0 gradients zero on the CPU: {zero}")
    check(all(float(out["cuda"]["grads"][n].abs().max()) == 0 for n in zero),
          f"{tag}: a gradient zero on the CPU is not zero on the card")
    want = ("flash_decode",) if cfg.hybrid else ()
    check(all((n > 0) == (k in want) for k, n in launches["cuda"].items()
              if k.startswith("flash_decode")),
          f"{tag}: decode launches {launches['cuda']}, expected {want}")
    diverged = []
    for rid, ref in out["cpu"]["tokens"].items():
        got = out["cuda"]["tokens"][rid]
        if got == ref:
            continue
        i = next(j for j, (a, c) in enumerate(zip(got, ref)) if a != c)
        ctx = prompts[rid] + ref[:i]
        _, logits = model.prefill(params, {"tokens": torch.tensor([ctx])},
                                  len(ctx))
        top2 = torch.topk(logits[0, -1].float(), 2).values
        margin = float(top2[0] - top2[1])
        print(f"[{tag}] request {rid} diverges at generated step {i}: cuda "
              f"{got[i]} cpu {ref[i]}, top-2 logit margin {margin:.3g}",
              flush=True)
        check(margin < 1e-3, f"{tag}: request {rid} diverged at step {i} "
                             f"with a top-2 margin {margin:.3g}")
        diverged.append({"rid": rid, "step": i, "margin": margin})
    print(f"[{tag}] greedy tokens identical: {not diverged} ({len(prompts)} "
          f"requests of {list(lens)} prompt tokens, near-tie divergences: "
          f"{len(diverged)})", flush=True)
    return {"model": cfg.name, "layers": 2, "loss_cuda": out["cuda"]["loss"],
            "loss_cpu": out["cpu"]["loss"], "loss_rel_diff": rel,
            "grad_scaled_diff": gerr, "zero_grads": zero,
            "identical": not diverged, "near_tie_divergences": diverged,
            "requests": len(prompts), "launches_cuda": launches["cuda"]}


# ---------------------------------------------------------------------------
# phase 6: the published model, trained through the kernels
# ---------------------------------------------------------------------------

def train_phase(torch, seed: int, card: str, arch: str = "granite-3-2b",
                tag: str = "train", kernels=TRAIN_KERNELS,
                state_bytes: bool = False) -> tuple[dict, dict]:
    """The published ``arch`` through the training launcher (AdamW,
    warmup_cosine(3e-4, 20, steps), clip 1.0, deterministic, bf16, remat),
    seq 2048, batch 4, 6 steps (``train_path``; ``kernels`` the attention
    kernels it must launch, none for an attention-free arch). With
    ``state_bytes``: the device bytes allocated once the launcher's params
    and AdamW state exist, before the first batch (``Trainer.run``
    watched), held to the dry-run's estimate for the config at one rank
    (``launch.dryrun.train_state_bytes``: params + the two float32
    moments); they may differ only by the caching allocator's rounding of
    each tensor up to 512 bytes."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.distributed.sharding import auto_rules
    from repro_torch.launch import dryrun
    from repro_torch.launch import train as launch_train
    from repro_torch.train import Trainer

    steps, seq, batch = 6, 2048, 4
    held = {}

    def run():
        return launch_train.main([
            "--arch", arch, "--device", "cuda", "--seed", str(seed),
            "--steps", str(steps), "--seq", str(seq), "--batch", str(batch),
            "--ckpt-every", "1000000",
            "--ckpt-dir", str(ROOT / "build" / "chip_smoke_train_ckpt")])

    def watched():
        torch.cuda.synchronize()
        base, start = torch.cuda.memory_allocated(), Trainer.run

        def first(trainer, *a, **kw):
            torch.cuda.synchronize()
            held["allocated"] = torch.cuda.memory_allocated() - base
            held["tensors"] = sum(len(tree_leaves(t)) for t in (
                trainer.params, trainer.opt_state["mu"],
                trainer.opt_state["nu"]))
            Trainer.run = start
            return start(trainer, *a, **kw)

        Trainer.run = first
        try:
            return run()
        finally:
            Trainer.run = start

    cfg = get_config(arch)
    rec, launches = train_path(
        torch, tag, cfg, watched if state_bytes else run, seq, batch, steps,
        "AdamW, warmup_cosine(3e-4, 20, 6), clip 1.0", card, kernels)
    if state_bytes:
        one = {"data": 1, "model": 1}
        est = dryrun.train_state_bytes(cfg, one, auto_rules(cfg, one))
        want = est["params"] + est["opt_state"]
        over = held["allocated"] - want
        check(0 <= over <= 512 * held["tensors"],
              f"{tag}: {held['allocated']} bytes allocated with the params "
              f"and AdamW state, the dry-run estimates {want} (params "
              f"{est['params']} + moments {est['opt_state']}); "
              f"{held['tensors']} tensors may round up by 512 bytes each")
        print(f"[{tag}] params + AdamW state on the card before the first "
              f"batch: {held['allocated']} bytes allocated, dry-run estimate "
              f"{want} (params {est['params']} + moments "
              f"{est['opt_state']}); {over} bytes over across "
              f"{held['tensors']} tensors (allocator rounding, at most 512 "
              f"each) [{card}]", flush=True)
        rec["state_bytes"] = dict(held, estimate=want)
    return rec, launches


def bert_train_phase(torch, seed: int, card: str) -> tuple[dict, dict]:
    """The published bert-large (24 layers, bf16, remat, non-causal over
    ``SyntheticLM``'s packed documents) with the MLPerf-BERT recipe
    (``lamb_recipe``, clip 1.0, deterministic) at seq 512 and batch 56 (the
    MLPerf step batch of 448 over the paper's 8 cards), 6 steps
    (``trainer_phase``)."""
    from repro_torch.configs import get_config

    arch, seq, batch = NEW_TRAIN_PATHS["train_bert"]
    cfg = dataclasses.replace(get_config(arch), attn_impl="pallas")
    return trainer_phase(torch, seed, card, "train-bert", cfg, seq, batch,
                         lamb_recipe,
                         "LAMB, warmup_poly(3.75e-3, 10, 7100), clip 1.0")


def olmoe_train_phase(torch, seed: int, card: str) -> tuple[dict, dict]:
    """olmoe-1b-7b at its published width (64 experts of d_ff 1024, top-8,
    16 heads of 128, untied head, bf16, remat) cut to 8 of its 16 layers,
    with the launcher's recipe (AdamW, warmup_cosine(3e-4, 20, 6), clip
    1.0), seq 2048, batch 4, 6 steps (``trainer_phase``)."""
    from repro_torch.configs import get_config
    from repro_torch.optim import adamw, warmup_cosine

    arch, seq, batch, layers = TRAIN_OLMOE
    cfg = dataclasses.replace(get_config(arch), num_layers=layers,
                              attn_impl="pallas")
    return trainer_phase(torch, seed, card, "train-olmoe", cfg, seq, batch,
                         lambda: adamw(warmup_cosine(3e-4, 20, 6)),
                         "AdamW, warmup_cosine(3e-4, 20, 6), clip 1.0")


def trainer_phase(torch, seed: int, card: str, tag: str, cfg, seq: int,
                  batch: int, recipe, recipe_text: str,
                  batch_at=None) -> tuple[dict, dict]:
    """``cfg`` with weights drawn on the card from ``seed``, trained 6 steps
    through ``make_train_step`` (``recipe()``, clip 1.0, deterministic) and
    the ``Trainer`` on ``SyntheticLM`` batches, or on ``batch_at(step)``
    (``train_path``)."""
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.train import Trainer, TrainerConfig, make_train_step

    steps = 6

    def run():
        model = build_model(cfg)
        params = model.init(torch.Generator(device="cuda").manual_seed(seed),
                            device="cuda")
        opt = recipe()
        step = make_train_step(model, opt, clip_norm=1.0, deterministic=True)
        batches = batch_at or SyntheticLM(cfg.vocab_size, seq, batch,
                                          seed=seed).batch_at
        trainer = Trainer(
            TrainerConfig(total_steps=steps, ckpt_every=1000000,
                          ckpt_dir=str(ROOT / "build" /
                                       f"chip_smoke_{tag}_ckpt")),
            step, params, opt.init(params), batches)
        trainer.run()
        return trainer

    return train_path(torch, tag, cfg, run, seq, batch, steps, recipe_text,
                      card)


def train_path(torch, tag, cfg, run, seq, batch, steps, recipe,
               card, kernels=TRAIN_KERNELS) -> tuple[dict, dict]:
    """One training main path: launch counters reset just before ``run()``
    (which builds the model and trains ``steps`` steps, returning the
    ``Trainer``) and each of ``kernels`` (flash_fwd, flash_bwd_dq_sm90 and
    flash_bwd_dkv_sm90) > 0 just after, every other kernel 0; every loss and
    grad norm finite; prints the first loss, tokens/s and ms/step over
    steps 2-``steps`` and peak memory, then profiles one more step
    (``profile_train``)."""
    dev = torch.device("cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    t0 = time.perf_counter()
    trainer = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated(dev)
    hist = trainer.history
    for name, n in launches.items():
        check((n > 0) == (name in kernels),
              f"kernel {name} was launched {n} times in the {tag} phase "
              f"(expected: {kernels} only)")
    check(len(hist) == steps, f"{tag} phase ran {len(hist)} of {steps} steps")
    for rec in hist:
        check(math.isfinite(rec["loss"]) and math.isfinite(rec["grad_norm"]),
              f"{tag} step {rec['step']}: loss {rec['loss']} grad norm "
              f"{rec['grad_norm']}")
    timed = [r["step_time_s"] for r in hist[1:]]    # step 1 compiles, warms up
    ms_step = sum(timed) / len(timed) * 1e3
    tok_s = seq * batch / (ms_step / 1e3)
    per_step = {n: launches[n] / steps for n in TRAIN_KERNELS}
    print(f"[{tag}] {cfg.name} {cfg.num_layers} layers {cfg.dtype} remat, "
          f"{'causal' if cfg.causal else 'non-causal'}, {recipe}, seq {seq} "
          f"batch {batch}: first loss {hist[0]['loss']:.4f} (ln "
          f"{cfg.vocab_size} = {math.log(cfg.vocab_size):.4f}), last "
          f"{hist[-1]['loss']:.4f}; {ms_step:.1f} ms/step, {tok_s:.0f} "
          f"tokens/s over steps 2-{steps}; peak memory {peak / 2**30:.2f} GiB; "
          f"launches {launches} ({per_step} a step) [{card}]", flush=True)
    if cfg.family == "moe":
        print(f"[{tag}] cross-entropy {[round(r['ce'], 4) for r in hist]}, "
              f"load-balancing aux {[round(r['aux'], 4) for r in hist]}",
              flush=True)
    profile = profile_train(torch, trainer)
    rec = {"model": cfg.name, "layers": cfg.num_layers, "dtype": cfg.dtype,
           "remat": cfg.remat, "causal": cfg.causal, "recipe": recipe,
           "seq": seq, "batch": batch, "steps": steps,
           "losses": [r["loss"] for r in hist],
           "grad_norms": [r["grad_norm"] for r in hist],
           "step_ms": [r["step_time_s"] * 1e3 for r in hist],
           "ms_per_step": ms_step, "tokens_per_s": tok_s, "wall_s": wall,
           "peak_memory_bytes": peak, "launches_per_step": per_step,
           "profile": profile, "card": card}
    if cfg.family == "moe":
        rec.update(ce=[r["ce"] for r in hist], aux=[r["aux"] for r in hist])
    return rec, launches


def profile_train(torch, trainer) -> dict:
    """One more train step under ``torch.profiler`` (not counted in the
    numbers above): device busy share of its wall time and the kernels
    that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    b = trainer.batch_fn(trainer.step)              # the next batch of the run
    ranged = ranged_layer(trainer.params["blocks"][0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            layer_ranges(torch, ranged):
        t0 = time.perf_counter()
        trainer.params, trainer.opt_state, metrics = trainer.step_fn(
            trainer.params, trainer.opt_state, b)
        float(metrics["loss"])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = device_kernels(prof)
    busy_us = sum(_device_us(e) for e in kernels)
    if busy_us <= 0:
        print("[profile] the profiler recorded no device time: not measured",
              flush=True)
        return {"busy_share": None}
    top = sorted(kernels, key=_device_us, reverse=True)[:10]
    out = {"wall_s": wall_us / 1e6, "device_busy_s": busy_us / 1e6,
           "busy_share": busy_us / wall_us,
           "top": [{"kernel": e.key[:90], "count": e.count,
                    "device_ms": _device_us(e) / 1e3} for e in top]}
    if ranged:
        out.update(range_share(prof, busy_us, ranged))
    print(f"[profile] one train step under torch.profiler: wall "
          f"{wall_us / 1e6:.3f}s, device busy {busy_us / 1e6:.3f}s "
          f"({busy_us / wall_us:.1%})"
          + (f"; {ranged} layer forwards {out[ranged + '_device_s']:.3f}s "
             f"({out[ranged + '_share_of_busy']})" if ranged else ""),
          flush=True)
    for t in out["top"]:
        print(f"[profile]   {t['device_ms']:9.2f} ms  x{t['count']:<6} "
              f"{t['kernel']}", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 2f: block-sparse FlashAttention (paper §3.3, Alg. 5)
# ---------------------------------------------------------------------------

# GPT-2 small's attention (12 heads of 64) at the reference's bench_fig2
# length, 4096, batch 4, and at Path-X's length, 16384, one sequence; a
# butterfly pattern of the paper's 128-row blocks, which ops.flash_attention
# refines into the kernels' 64-row tiles. (batch, seq, causal, kv_mask)
BLOCKSPARSE = {"blocksparse_4k": (4, 4096, False, False),
               "blocksparse_4k_causal": (4, 4096, True, False),
               "blocksparse_4k_kvmask": (4, 4096, False, True),
               "blocksparse_16k": (1, 16384, False, False)}
BLOCKSPARSE_HEADS, BLOCKSPARSE_D, BLOCKSPARSE_BLOCK = 12, 64, 128


def _sparse_inputs(torch, gen, path):
    """(pattern at 128-row blocks, the same refined to the kernels' tiles,
    kv_mask or None) of a ``BLOCKSPARSE`` path."""
    from repro_torch.core import masks as M
    from repro_torch.kernels import tuning

    b, S, causal, masked = BLOCKSPARSE[path]
    pattern = M.butterfly_block_layout(S, S, BLOCKSPARSE_BLOCK,
                                       BLOCKSPARSE_BLOCK, causal=causal)
    tile, r = tuning.sparse_tile(BLOCKSPARSE_BLOCK, on_card=True)
    kvm = None
    if masked:          # ragged valid lengths: PARTIAL_DATA and SKIP tiles
        lens = torch.tensor([S, S - 1000, S - 77, S // 2], device="cuda")[:b]
        kvm = torch.arange(S, device="cuda")[None, :] < lens[:, None]
        kvm &= torch.rand(b, S, generator=gen, device="cuda") > 0.05
    return pattern, M.refine_block_layout(pattern, r, r), kvm


def blocksparse_path(torch, seed: int, path: str) -> dict:
    """The path as a user calls it: ``ops.flash_attention(block_layout=
    ...)`` forward and backward through autograd, bf16, launch counters
    reset just before and read just after: flash_fwd_sm90,
    flash_bwd_dq_sm90 and flash_bwd_dkv_sm90 once each and nothing else; o
    and the gradients finite."""
    from repro_torch.kernels import ops

    b, S, causal, _ = BLOCKSPARSE[path]
    gen = torch.Generator(device="cuda").manual_seed(seed + 40)
    pattern, _, kvm = _sparse_inputs(torch, gen, path)
    h, d = BLOCKSPARSE_HEADS, BLOCKSPARSE_D
    q, k, v, do = (torch.randn(b, h, S, d, generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(4))
    leaves = [t.requires_grad_() for t in (q, k, v)]
    torch.cuda.synchronize()
    reset_launches()
    o = ops.flash_attention(*leaves, causal=causal, kv_mask=kvm,
                            block_layout=pattern)
    grads = torch.autograd.grad(o, leaves, do)
    torch.cuda.synchronize()
    launches = read_launches()
    for name, n in launches.items():
        check(n == (1 if name in TRAIN_KERNELS else 0),
              f"{path}: {name} launched {n} times by one forward + backward")
    check(all(bool(torch.isfinite(t).all()) for t in (o, *grads)),
          f"{path}: o or a gradient is not finite")
    return launches


def _dense_times(torch, fa, q, k, v, do, kvm, causal, call):
    """Device ms of #1 and of the dq + dkv pair at the same shape without
    the sparse pattern (causal or not, the kv_mask kept)."""
    from repro_torch.core import masks as M

    S = q.shape[2]
    layout = M.compile_block_layout(
        M.MaskSpec(causal=causal, kv_mask=kvm), S, S, call["block_q"],
        call["block_k"]).as_array(q.device)
    fwd = device_ms(torch, [lambda: fa.flash_attention_forward(
        q, k, v, kvm, layout, **call)])
    o, m, l = fa.flash_attention_forward(q, k, v, kvm, layout, **call)
    ops_ = fa.prepare_backward(q, k, v, o, do, m, l, kvm, layout, **call)
    pair = (device_ms(torch, [lambda: fa.launch_dq(ops_)])
            + device_ms(torch, [lambda: fa.launch_dkv(ops_)]))
    return fwd, pair


def _sparse_notes(entries: dict, layout, dense_fwd, dense_pair, pattern):
    """Density, skipped tiles and the dense times, into each entry."""
    from repro_torch.core import masks as M

    skipped = int((layout == M.BLOCK_SKIP).sum())
    notes = {"density": M.layout_density(pattern),
             "tiles_skipped": skipped, "tiles": layout.numel(),
             "partial_data_tiles": int((layout == M.BLOCK_PARTIAL_DATA).sum()),
             "dense_fwd_ms": dense_fwd, "dense_pair_ms": dense_pair}
    for e in entries.values():
        e.update(notes)
        e["shape"] += (f", butterfly {BLOCKSPARSE_BLOCK}-blocks density "
                       f"{notes['density']:.4f}, {skipped} of "
                       f"{layout.numel()} 64-tiles skipped "
                       f"({skipped / layout.numel():.1%}"
                       + (", every row's layout" if layout.ndim == 3 else "")
                       + ")")
    print(f"[blocksparse] {entries['flash_fwd_sm90']['shape']}: #1 "
          f"{entries['flash_fwd_sm90']['ms']:.4f} ms against dense "
          f"{dense_fwd:.4f}"
          f" ms; dq + dkv {entries['flash_bwd_dq_sm90']['pair_device_ms']:.4f} ms "
          f"against dense {dense_pair:.4f} ms", flush=True)


def blocksparse_phase(torch, seed: int) -> tuple[dict, dict]:
    """Each ``BLOCKSPARSE`` path once as a user calls it
    (``blocksparse_path``), then its kernels held against their plain
    versions at its shape through ``fwd_bwd_case``: (4, 12, 4096, 64)
    non-causal, causal, non-causal with a kv_mask, and (1, 12, 16384, 64)
    non-causal (its plain versions by groups of heads), each beside its
    density, skipped tiles and the dense kernels' times at the same shape
    (Prop. 4).
    Returns ({kernel: {path: entry}}, {path: launches})."""
    from repro_torch.kernels import flash_attention as fa

    at, paths = {}, {}
    for path in BLOCKSPARSE:
        paths[path] = blocksparse_path(torch, seed, path)
        release(torch)
    gen = torch.Generator(device="cuda").manual_seed(seed + 42)
    h, d = BLOCKSPARSE_HEADS, BLOCKSPARSE_D
    for path, (b, S, causal, _) in BLOCKSPARSE.items():
        pattern, fine, kvm = _sparse_inputs(torch, gen, path)
        c = fwd_bwd_case(torch, gen, b, h, h, S, d, causal, None,
                         sparse=fine, kv_mask=kvm)
        entries = shape_entries(c)
        q, k, v, _, do = c["res"][:5]
        dense = _dense_times(torch, fa, q, k, v, do, kvm, causal, c["call"])
        _sparse_notes(entries, c["layout"], *dense, pattern)
        del c, q, k, v, do
        for name, e in entries.items():
            at.setdefault(name, {})[path] = e
        release(torch)
    return at, paths


# ---------------------------------------------------------------------------
# phases 2g and 15: the encoder-decoder, seamless-m4t-medium
# ---------------------------------------------------------------------------

SEAMLESS = "seamless-m4t-medium"
# serve-seamless: sequences, audio frames, prompt tokens, decode steps, and
# the self-attention cache (prompt + steps, rounded up to the decode tile)
SEAMLESS_SERVE = (4, 1024, 64, 32, 128)
# serve-seamless: max |logit - plain logit| at any step, both paths fed the
# same tokens: four bf16 spacings at the top logits (~0.25, where one is
# 2**-9); the readings on an H100 were at most 0.00293
SEAMLESS_LOGIT_ATOL = 4 * 2.0 ** -9
# train-seamless: batch, frames, tokens (the reference's S/2 + S/2 of a
# 2048-position sequence), steps
SEAMLESS_TRAIN = (4, 1024, 1024, 6)


def seamless_kernel_phase(torch, seed: int) -> dict:
    """The kernels at seamless-m4t-medium's shapes (16 heads of 64, MHA,
    bf16): #1, #2 and #3 at train-seamless's layers, (4, 16, 1024, 64)
    non-causal (the encoder's self-attention and the decoder's
    cross-attention, frames and tokens alike 1024 long) and causal (the
    decoder's self-attention), through ``fwd_bwd_case``; #1 at
    serve-seamless's cross-attention prefill (64 decoder rows against
    1024 encoder rows); #7 at its cross-attention decode (the 1024-row
    cache, kv_len 1024) and its self-attention decode (the 128-row cache at
    its last step, kv_len 96). Returns {kernel: {path: entry}}, the
    decoder's and the self-attention decode's under their path's entry."""
    from repro_torch.core import masks as M
    from repro_torch.kernels import tuning

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 50)
    b, n_frames, n_prompt, steps, cap = SEAMLESS_SERVE
    h, d = 16, 64
    enc = shape_entries(fwd_bwd_case(torch, gen, SEAMLESS_TRAIN[0], h, h,
                                     SEAMLESS_TRAIN[1], d, False, None,
                                     mma="train_seamless" in MMA_SHAPES))
    release(torch)
    dec = shape_entries(fwd_bwd_case(torch, gen, SEAMLESS_TRAIN[0], h, h,
                                     SEAMLESS_TRAIN[2], d, True, None))
    release(torch)
    for name, e in enc.items():
        e["shape"] = "seamless encoder self / decoder cross " + e["shape"]
        e["decoder_self"] = dec[name]
        dec[name]["shape"] = "seamless decoder self " + dec[name]["shape"]

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    layout = M.compile_block_layout(M.MaskSpec(), n_prompt, n_frames, 64,
                                    64).as_array(dev)
    call = dict(scale=d ** -0.5, causal=False, window=None, q_offset=0,
                block_q=64, block_k=64)
    cross = _without_launches({"f": packed_prefill_record(
        torch, gen, (randn(b, h, n_prompt, d), randn(b, h, n_frames, d),
                     randn(b, h, n_frames, d), None, layout), call,
        f"serve-seamless cross-attention prefill b={b} hq={h} hkv={h} "
        f"{n_prompt} decoder rows against {n_frames} encoder rows d={d}, "
        f"non-causal", mma="serve_seamless" in MMA_SHAPES)})["f"]

    def decode(capacity, kv):
        kv_len = torch.full((b,), kv, dtype=torch.int32, device=dev)
        bk, splits = tuning.resolve_decode_geometry(capacity, None, None)
        lay = M.kv_block_layout(M.decode_kv_valid(kv_len, capacity), bk)
        rec = contiguous_decode_record_at(
            torch, gen, (randn(b, h, 1, d), randn(b, h, capacity, d),
                         randn(b, h, capacity, d), kv_len, lay),
            dict(scale=d ** -0.5, block_k=bk, num_splits=splits, window=None,
                 kv_mask=None))
        rec.pop("launches")
        return rec

    cross_dec = decode(n_frames, n_frames)
    cross_dec["shape"] = "serve-seamless cross-attention " + cross_dec["shape"]
    self_dec = decode(cap, n_prompt + steps)
    self_dec["shape"] = "serve-seamless self-attention " + self_dec["shape"]
    cross_dec["self"] = self_dec
    return {"flash_fwd_sm90": {"train_seamless": enc["flash_fwd_sm90"],
                               "serve_seamless": cross},
            "flash_bwd_dq_sm90": {"train_seamless": enc["flash_bwd_dq_sm90"]},
            "flash_bwd_dkv_sm90": {"train_seamless": enc["flash_bwd_dkv_sm90"]},
            "flash_decode": {"serve_seamless": cross_dec}}


def seamless_parity_phase(torch, seed: int, tag: str = "seamless-parity"
                          ) -> dict:
    """seamless-m4t-medium at full width, 2 encoder + 2 decoder layers,
    float32: the same weights (drawn on the card from ``seed``) on
    ``cuda`` (kernels: #1-#3, #7) and on ``cpu`` (plain versions). The
    loss of one batch (2 x 256 frames + 256 tokens) within 1e-4 relative
    and every layer-0 gradient of both stacks (the decoder's
    cross-attention included) and ``frontend_proj``'s within 1e-4 scaled
    by its max; then prefill (300 frames, a 24-token prompt) and 8 greedy
    decode steps: tokens identical, a divergence allowed only at a
    near-tie of the CPU's logits (top-2 margin < 1e-3)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, params_to

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config(SEAMLESS), num_layers=2,
                              num_encoder_layers=2, dtype="float32",
                              attn_impl="pallas", use_decode_kernel=True)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(seed),
                        device="cpu")
    gen = torch.Generator().manual_seed(seed + 8)
    batch = {"frames": torch.randn(2, 256, cfg.frontend_dim, generator=gen),
             "tokens": torch.randint(1, cfg.vocab_size, (2, 256),
                                     generator=gen)}
    frames = torch.randn(2, 300, cfg.frontend_dim, generator=gen)
    prompt = torch.randint(1, cfg.vocab_size, (2, 24), generator=gen)
    out, launches = {}, {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        p = params_to(params, device)
        loss, g = _grads(torch, model, p,
                         {k: t.to(device) for k, t in batch.items()})
        grads = {f"{stack}/{k}/{n}": t.cpu()
                 for stack in ("enc_blocks", "blocks")
                 for k, v in g[stack][0].items() for n, t in v.items()}
        grads["frontend_proj"] = g["frontend_proj"].cpu()
        del g
        reset_launches()
        state, lg = model.prefill(p, {"frames": frames.to(device),
                                      "tokens": prompt.to(device)}, 64)
        toks, logits = [], []
        for _ in range(8):
            logits.append(lg[:, -1].float().cpu())
            toks.append(lg[:, -1].argmax(-1))
            state, lg = model.decode_step(p, state, toks[-1])
        launches[device] = read_launches()
        out[device] = {"loss": loss, "grads": grads, "logits": logits,
                       "tokens": torch.stack(toks, 1).cpu().tolist()}
        del p, state
        print(f"[{tag}] {cfg.name} 2 + 2 layers float32, {device}: loss "
              f"{loss}, tokens {out[device]['tokens']} in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
    rel = abs(out["cuda"]["loss"] - out["cpu"]["loss"]) / abs(out["cpu"]["loss"])
    gerr = {n: scaled_err(out["cuda"]["grads"][n], out["cpu"]["grads"][n])
            for n in out["cpu"]["grads"]}
    print(f"[{tag}] loss relative difference {rel:.3g}; largest layer-0 "
          f"scaled grad difference {max(gerr.values()):.3g} "
          f"({max(gerr, key=gerr.get)}); launches on the card "
          f"{launches['cuda']}", flush=True)
    check(rel <= 1e-4, f"{tag}: losses differ by {rel} > 1e-4")
    check(max(gerr.values()) <= 1e-4,
          f"{tag}: layer-0 grads differ by {gerr} > 1e-4")
    check(all(float(out["cpu"]["grads"][n].abs().max()) > 0 for n in gerr),
          f"{tag}: a layer-0 gradient is zero on the CPU")
    check(launches["cuda"]["flash_fwd"] > 0
          and launches["cuda"]["flash_decode"] > 0,
          f"{tag}: launches on the card {launches['cuda']}")
    diverged = []
    for row, (got, ref) in enumerate(zip(out["cuda"]["tokens"],
                                         out["cpu"]["tokens"])):
        if got == ref:
            continue
        i = next(j for j, (a, c) in enumerate(zip(got, ref)) if a != c)
        top2 = torch.topk(out["cpu"]["logits"][i][row], 2).values
        margin = float(top2[0] - top2[1])
        print(f"[{tag}] row {row} diverges at step {i}: cuda {got[i]} cpu "
              f"{ref[i]}, top-2 logit margin {margin:.3g}", flush=True)
        check(margin < 1e-3, f"{tag}: row {row} diverged at step {i} with "
                             f"a top-2 margin {margin:.3g}")
        diverged.append({"row": row, "step": i, "margin": margin})
    print(f"[{tag}] greedy tokens identical: {not diverged}", flush=True)
    return {"model": cfg.name, "layers": "2 + 2",
            "loss_cuda": out["cuda"]["loss"], "loss_cpu": out["cpu"]["loss"],
            "loss_rel_diff": rel, "grad_scaled_diff": gerr,
            "identical": not diverged, "near_tie_divergences": diverged,
            "launches_cuda": launches["cuda"]}


def _bf16_near_tie(top1: float, margin: float) -> bool:
    """A bf16 logit margin of at most two bf16 spacings at the top logit."""
    return margin <= 2 * 2.0 ** (math.floor(math.log2(max(abs(top1),
                                                          2 ** -60))) - 7)


def _greedy(torch, model, params, front, prompt, cap, steps, forced=None):
    """Prefill (``front``: the batch's frontend embeddings, ``{"frames":
    ...}`` or ``{"patches": ...}``, and the prompt), then ``steps`` decode
    steps through the model-level loop,
    each feeding the last token: the greedy one, or with ``forced`` (b,
    steps + 1 tokens) the forced one (teacher forcing). Returns (tokens
    (b, steps + 1) on the host, the float32 logits each token was read
    from, prefill seconds, per-step seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, lg = model.prefill(params, {**front, "tokens": prompt}, cap)
    toks, logits, step_s = [], [], []
    prefill_s = None
    for i in range(steps + 1):
        if i:
            t1 = time.perf_counter()
            state, lg = model.decode_step(params, state, tok)
        logits.append(lg[:, -1].float())
        tok = lg[:, -1].argmax(-1)
        if forced is not None:
            tok = torch.tensor([row[i] for row in forced], device=tok.device)
        toks.append(tok.tolist())                # the host reads each token
        if i:
            step_s.append(time.perf_counter() - t1)
        else:
            prefill_s = time.perf_counter() - t0
    return [list(r) for r in zip(*toks)], logits, prefill_s, step_s


def _bf16_ties(tokens, logits, tag: str, near_tie=_bf16_near_tie
               ) -> tuple[int, list]:
    """``tokens`` (b, n) against the argmax of ``logits`` (n tensors of (b,
    V)), token by token: (how many are the argmax, the others with their
    margin below the maximum, each a near-tie, ``near_tie(top, margin)``,
    or the check fails)."""
    same, ties = 0, []
    for i, lg in enumerate(logits):
        top = lg.max(dim=-1).values
        for r, row in enumerate(tokens):
            if int(lg[r].argmax()) == row[i]:
                same += 1
                continue
            margin = float(top[r] - lg[r, row[i]])
            ties.append({"row": r, "token": i, "margin": margin,
                         "top": float(top[r])})
            check(near_tie(float(top[r]), margin),
                  f"{tag}: row {r} token {i} is {margin:.3g} below "
                  f"the plain path's maximum {float(top[r]):.3g} (not a bf16 "
                  f"near-tie)")
    return same, ties


def seamless_serve_phase(torch, seed: int, card: str,
                         tag: str = "serve-seamless") -> tuple[dict, dict]:
    """The published seamless-m4t-medium (12 + 12 layers, d 1024, 16 heads
    of 64, bf16, random weights drawn on the card from ``seed``) served
    through the model-level loop the reference tests (the engine refuses
    the family, as the reference's cannot serve it): 4 sequences of 1024
    audio frames and a 64-token prompt, one prefill (the encoder, #1
    non-causal; the decoder's self- and cross-attention, #1; the cross
    caches), then 32 greedy decode steps (self- and cross-attention
    through #7), held to the plain path (``model_level_serve``) with every
    logit within ``SEAMLESS_LOGIT_ATOL`` of the plain path's."""
    from repro_torch.configs import get_config

    dev = torch.device("cuda")
    b, n_frames, n_prompt, steps, cap = SEAMLESS_SERVE
    cfg = dataclasses.replace(get_config(SEAMLESS), attn_impl="pallas",
                              use_decode_kernel=True)
    gen = torch.Generator(device=dev).manual_seed(seed + 9)
    frames = torch.randn(b, n_frames, cfg.frontend_dim, generator=gen,
                         device=dev)
    prompt = torch.randint(1, cfg.vocab_size, (b, n_prompt), generator=gen,
                           device=dev)
    rec, launches = model_level_serve(
        torch, seed, card, tag, cfg, {"frames": frames}, prompt, cap, steps,
        lambda top: SEAMLESS_LOGIT_ATOL,
        f"{cfg.num_encoder_layers} + {cfg.num_layers}")
    rec.update(frames=n_frames)
    return rec, launches


def model_level_serve(torch, seed, card, tag, cfg, front, prompt, cap, steps,
                      logit_atol, layers: str, near_tie=None
                      ) -> tuple[dict, dict]:
    """``cfg`` (bf16, random weights drawn on the card from ``seed``) served
    through the model-level loop (``_greedy``: a prefill of ``front`` and
    ``prompt``, then ``steps`` greedy decode steps): the engine refuses a
    model with frontend embeddings, as the reference's cannot serve it.
    Launch counters reset just before and read just after: flash_fwd and
    flash_decode > 0, every other kernel 0. Then the plain path (the same
    weights with ``attn_impl="chunked"`` and the plain decode: no kernel)
    reads the same tokens (teacher forcing): each greedy token of the
    kernels must be the argmax of the plain path's logits at its step, or
    tie with it (``near_tie(top, margin)``, by default ``_bf16_near_tie``:
    random weights give flat logits, where exact ties are common), and
    every logit at every step within ``atol = logit_atol(max |plain
    logit|)`` of the plain path's (``near_tie`` may read ``atol``:
    called as ``near_tie(top, margin, atol)`` when given). Prints
    tokens/s, the prefill's time, decode step p50 and peak memory; then 8
    decode steps once more under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import build_model

    dev = torch.device("cuda")
    b, n_prompt = prompt.shape
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(seed),
                        device=dev)
    torch.cuda.synchronize()
    print(f"[{tag}] {cfg.name}: {layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads of {cfg.head_dim}, {cfg.dtype}, weights in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    _greedy(torch, model, params, front, prompt, cap, 2)   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    t0 = time.perf_counter()
    toks, klogits, prefill_s, step_s = _greedy(torch, model, params, front,
                                               prompt, cap, steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated(dev)
    for name, n in launches.items():
        check((n > 0) == (name in DENSE_SERVE_KERNELS),
              f"kernel {name} was launched {n} times in the {tag} phase")
    # the plain path on the kernels' tokens: at every token, the kernels'
    # choice must be the plain logits' argmax, or tie with it in bf16
    plain = build_model(dataclasses.replace(cfg, attn_impl="chunked",
                                            use_decode_kernel=False))
    _, plogits, _, _ = _greedy(torch, plain, params, front, prompt, cap,
                               steps, forced=toks)
    # the same tokens in, so every logit is held to the plain path's
    diffs = [float((a - p).abs().max()) for a, p in zip(klogits, plogits)]
    top = max(float(p.abs().max()) for p in plogits)
    atol = logit_atol(top)
    print(f"[{tag}] max |logit - plain| at each of the {steps + 1} steps: "
          f"{', '.join(f'{x:.4g}' for x in diffs)} (max |plain logit| "
          f"{top:.4g}; limit {atol:.4g})", flush=True)
    tie = (_bf16_near_tie if near_tie is None
           else lambda t, m: near_tie(t, m, atol))
    same, ties = _bf16_ties(toks, plogits, tag, tie)
    for t in ties:
        print(f"[{tag}] row {t['row']} token {t['token']}: the plain path's "
              f"logit of the kernels' token is {t['margin']:.3g} below its "
              f"maximum {t['top']:.3g} (a near-tie)", flush=True)
    check(max(diffs) <= atol,
          f"{tag}: max |logit - plain| {max(diffs)} > {atol}")
    n_tok = b * (steps + 1)
    step_p50 = sorted(step_s)[len(step_s) // 2]
    print(f"[{tag}] {n_tok} tokens ({b} sequences, the prefill's and {steps} "
          f"decode steps') in {wall:.2f}s: {n_tok / wall:.1f} tok/s, prefill "
          f"{prefill_s * 1e3:.1f} ms, decode step p50 {step_p50 * 1e3:.1f} "
          f"ms, peak memory {peak / 2**30:.2f} GiB, launches {launches}; "
          f"the plain path's greedy choice at {same} of {n_tok} tokens, "
          f"bf16 near-ties at {len(ties)} [{card}]", flush=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        _greedy(torch, model, params, front, prompt, cap, 8)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t1) * 1e6
    kernels = device_kernels(prof)
    busy_us = sum(_device_us(e) for e in kernels)
    profile_rec = {"busy_share": busy_us / wall_us if busy_us > 0 else None,
                   "wall_s": wall_us / 1e6, "device_busy_s": busy_us / 1e6,
                   "decode_steps": 8,
                   "top": [{"kernel": e.key[:90], "count": e.count,
                            "device_ms": _device_us(e) / 1e3}
                           for e in sorted(kernels, key=_device_us,
                                           reverse=True)[:8]]}
    print(f"[profile] {tag} prefill + 8 decode steps under torch.profiler: "
          f"wall {wall_us / 1e6:.3f}s, device busy {busy_us / 1e6:.3f}s "
          + (f"({busy_us / wall_us:.1%})" if busy_us > 0
             else "(no device time recorded: not measured)"), flush=True)
    for t in profile_rec["top"]:
        print(f"[profile]   {t['device_ms']:9.2f} ms  x{t['count']:<6} "
              f"{t['kernel']}", flush=True)
    rec = {"model": cfg.name, "layers": layers, "dtype": cfg.dtype,
           "sequences": b, "prompt_tokens": n_prompt,
           "decode_steps": steps, "new_tokens": n_tok, "wall_s": wall,
           "tokens_per_s": n_tok / wall, "prefill_s": prefill_s,
           "decode_step_p50_s": step_p50, "peak_memory_bytes": peak,
           "plain_argmax_tokens": same, "bf16_near_ties": ties,
           "max_abs_logit_diff_by_step": diffs,
           "max_abs_plain_logit": top, "logit_atol": atol,
           "profile": profile_rec,
           "card": card}
    return rec, launches


def seamless_batch(torch, cfg, b: int, n_frames: int, n_tokens: int,
                   seed: int) -> dict:
    """train-seamless's batch: audio frames drawn on the card and
    ``SyntheticLM`` token rows with their loss mask (its segment ids
    dropped: an encoder-decoder takes none)."""
    from repro_torch.data import SyntheticLM

    gen = torch.Generator(device="cuda").manual_seed(seed + 11)
    text = SyntheticLM(cfg.vocab_size, n_tokens, b, seed=seed).batch_at(0)
    return {"frames": torch.randn(b, n_frames, cfg.frontend_dim,
                                  generator=gen, device="cuda"),
            "tokens": text["tokens"], "loss_mask": text["loss_mask"]}


def seamless_train_phase(torch, seed: int, card: str) -> tuple[dict, dict]:
    """The published seamless-m4t-medium (bf16, remat) trained 6 steps
    through ``make_train_step`` and the ``Trainer`` with frames in the
    batch (``seamless_batch``: 4 rows of 1024 frames + 1024 tokens), AdamW
    with warmup_cosine(1e-3, 2, 6), clip 1.0 (``trainer_phase``; the train
    launcher refuses the family, whose batches ``SyntheticLM`` does not
    make). Every step takes the same batch: ``SyntheticLM``'s token chains
    over 256,206 words hold no structure that 6 steps of fresh batches
    can learn (their loss stays at ln V), and a repeated batch must be
    learnt, so the losses must be finite and the last below the first.
    The work of a step does not depend on the data."""
    from repro_torch.configs import get_config
    from repro_torch.optim import adamw, warmup_cosine

    b, n_frames, n_tokens, steps = SEAMLESS_TRAIN
    cfg = dataclasses.replace(get_config(SEAMLESS), attn_impl="pallas")
    rec, launches = trainer_phase(
        torch, seed, card, "train-seamless", cfg, n_frames + n_tokens, b,
        lambda: adamw(warmup_cosine(1e-3, 2, steps)),
        "AdamW, warmup_cosine(1e-3, 2, 6), clip 1.0",
        batch_at=lambda step, batch=seamless_batch(
            torch, cfg, b, n_frames, n_tokens, seed): batch)
    check(rec["losses"][-1] < rec["losses"][0],
          f"train-seamless: the loss did not fall ({rec['losses']})")
    return rec, launches


PHI3V = "phi-3-vision-4.2b"
# serve-phi3v: sequences, patch rows, prompt tokens, decode steps, cache
# capacity (patches + prompt + steps)
PHI3V_SERVE = (4, 576, 64, 32, 672)
# serve-phi3v: max |logit - plain logit| at any step, both paths fed the
# same tokens, in bf16 spacings at the largest |plain logit| (2**-5 at a
# top of 5.0); the readings on an H100 were 0.090-0.112 a step, 2.9-3.6
# spacings: 32 bf16 layers drift further than seamless's 12 + 12 (0.003 at
# a top of 0.26: 1.5 spacings), while float32 parity is exact
PHI3V_LOGIT_SPACINGS = 6
# train-phi3v: batch, patch rows, tokens (patches + text = the reference's
# seq_len, 2048), steps
PHI3V_TRAIN = (4, 576, 1472, 6)


def phi3v_kernel_phase(torch, seed: int) -> dict:
    """The kernels at phi-3-vision-4.2b's shapes (32 heads of 96, MHA,
    bf16): #1, #2 and #3 at train-phi3v's layer, (4, 32, 2048, 96) causal
    over patches and text, through ``fwd_bwd_case``; #1 at serve-phi3v's
    prefill, (4, 32, 640, 96) causal (576 patch rows and a 64-token
    prompt); #7 at its decode, 4 lanes over the 672-row cache at its last
    step. Returns {kernel: {path: entry}}."""
    from repro_torch.core import masks as M
    from repro_torch.kernels import tuning

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 60)
    b, n_patch, n_prompt, steps, cap = PHI3V_SERVE
    tb, t_patch, t_text, _ = PHI3V_TRAIN
    h, d = 32, 96
    train = shape_entries(fwd_bwd_case(torch, gen, tb, h, h, t_patch + t_text,
                                       d, True, None,
                                       mma="train_phi3v" in MMA_SHAPES))
    release(torch)
    for e in train.values():
        e["shape"] = "train-phi3v " + e["shape"]

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    s = n_patch + n_prompt
    layout = M.compile_block_layout(M.MaskSpec(causal=True), s, s, 64,
                                    64).as_array(dev)
    call = dict(scale=d ** -0.5, causal=True, window=None, q_offset=0,
                block_q=64, block_k=64)
    prefill = _without_launches({"f": packed_prefill_record(
        torch, gen, (randn(b, h, s, d), randn(b, h, s, d), randn(b, h, s, d),
                     None, layout), call,
        f"serve-phi3v prefill b={b} hq={h} hkv={h} S={s} ({n_patch} patch "
        f"rows + a {n_prompt}-token prompt) d={d}, causal")})["f"]
    release(torch)
    kv_len = torch.full((b,), cap, dtype=torch.int32, device=dev)
    bk, splits = tuning.resolve_decode_geometry(cap, None, None)
    lay = M.kv_block_layout(M.decode_kv_valid(kv_len, cap), bk)
    dec = contiguous_decode_record_at(
        torch, gen, (randn(b, h, 1, d), randn(b, h, cap, d),
                     randn(b, h, cap, d), kv_len, lay),
        dict(scale=d ** -0.5, block_k=bk, num_splits=splits, window=None,
             kv_mask=None))
    dec.pop("launches")
    dec["shape"] = "serve-phi3v " + dec["shape"]
    return {"flash_fwd_sm90": {"train_phi3v": train["flash_fwd_sm90"],
                               "serve_phi3v": prefill},
            "flash_bwd_dq_sm90": {"train_phi3v": train["flash_bwd_dq_sm90"]},
            "flash_bwd_dkv_sm90": {"train_phi3v": train["flash_bwd_dkv_sm90"]},
            "flash_decode": {"serve_phi3v": dec}}


def phi3v_parity_phase(torch, seed: int, tag: str = "phi3v-parity") -> dict:
    """phi-3-vision-4.2b at full width (d 3072, 32 heads of 96), 2 layers,
    float32: the same weights (drawn on the card from ``seed``) on
    ``cuda`` (kernels: #1-#3 at d 96, #7) and on ``cpu`` (plain versions).
    The loss of one batch (2 x (576 patches + 64 tokens)) within 1e-4
    relative and every layer-0 gradient and ``frontend_proj``'s within
    1e-4 scaled by its max; then prefill (576 patches and a 24-token
    prompt) and 8 greedy decode steps: tokens identical, a divergence
    allowed only at a near-tie of the CPU's logits (top-2 margin < 1e-3)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, params_to

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config(PHI3V), num_layers=2,
                              dtype="float32", attn_impl="pallas",
                              use_decode_kernel=True)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(seed),
                        device="cpu")
    gen = torch.Generator().manual_seed(seed + 12)
    n_patch = cfg.frontend_tokens
    batch = {"patches": torch.randn(2, n_patch, cfg.frontend_dim,
                                    generator=gen),
             "tokens": torch.randint(1, cfg.vocab_size, (2, 64),
                                     generator=gen)}
    patches = torch.randn(2, n_patch, cfg.frontend_dim, generator=gen)
    prompt = torch.randint(1, cfg.vocab_size, (2, 24), generator=gen)
    out, launches = {}, {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        p = params_to(params, device)
        loss, g = _grads(torch, model, p,
                         {k: t.to(device) for k, t in batch.items()})
        grads = {f"blocks/{k}/{n}": t.cpu()
                 for k, v in g["blocks"][0].items() for n, t in v.items()}
        grads["frontend_proj"] = g["frontend_proj"].cpu()
        del g
        reset_launches()
        state, lg = model.prefill(p, {"patches": patches.to(device),
                                      "tokens": prompt.to(device)},
                                  n_patch + 64)
        toks, logits = [], []
        for _ in range(8):
            logits.append(lg[:, -1].float().cpu())
            toks.append(lg[:, -1].argmax(-1))
            state, lg = model.decode_step(p, state, toks[-1])
        launches[device] = read_launches()
        out[device] = {"loss": loss, "grads": grads, "logits": logits,
                       "tokens": torch.stack(toks, 1).cpu().tolist()}
        del p, state
        print(f"[{tag}] {cfg.name} 2 layers float32, {device}: loss {loss}, "
              f"tokens {out[device]['tokens']} in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
    rel = abs(out["cuda"]["loss"] - out["cpu"]["loss"]) / abs(out["cpu"]["loss"])
    gerr = {n: scaled_err(out["cuda"]["grads"][n], out["cpu"]["grads"][n])
            for n in out["cpu"]["grads"]}
    print(f"[{tag}] loss relative difference {rel:.3g}; largest layer-0 "
          f"scaled grad difference {max(gerr.values()):.3g} "
          f"({max(gerr, key=gerr.get)}); launches on the card "
          f"{launches['cuda']}", flush=True)
    check(rel <= 1e-4, f"{tag}: losses differ by {rel} > 1e-4")
    check(max(gerr.values()) <= 1e-4,
          f"{tag}: layer-0 grads differ by {gerr} > 1e-4")
    check(all(float(out["cpu"]["grads"][n].abs().max()) > 0 for n in gerr),
          f"{tag}: a layer-0 gradient is zero on the CPU")
    check(launches["cuda"]["flash_fwd"] > 0
          and launches["cuda"]["flash_decode"] > 0,
          f"{tag}: launches on the card {launches['cuda']}")
    diverged = []
    for row, (got, ref) in enumerate(zip(out["cuda"]["tokens"],
                                         out["cpu"]["tokens"])):
        if got == ref:
            continue
        i = next(j for j, (a, c) in enumerate(zip(got, ref)) if a != c)
        top2 = torch.topk(out["cpu"]["logits"][i][row], 2).values
        margin = float(top2[0] - top2[1])
        print(f"[{tag}] row {row} diverges at step {i}: cuda {got[i]} cpu "
              f"{ref[i]}, top-2 logit margin {margin:.3g}", flush=True)
        check(margin < 1e-3, f"{tag}: row {row} diverged at step {i} with "
                             f"a top-2 margin {margin:.3g}")
        diverged.append({"row": row, "step": i, "margin": margin})
    print(f"[{tag}] greedy tokens identical: {not diverged}", flush=True)
    return {"model": cfg.name, "layers": 2,
            "loss_cuda": out["cuda"]["loss"], "loss_cpu": out["cpu"]["loss"],
            "loss_rel_diff": rel, "grad_scaled_diff": gerr,
            "identical": not diverged, "near_tie_divergences": diverged,
            "launches_cuda": launches["cuda"]}


def phi3v_serve_phase(torch, seed: int, card: str,
                      tag: str = "serve-phi3v") -> tuple[dict, dict]:
    """The published phi-3-vision-4.2b (32 layers, d 3072, 32 heads of 96,
    bf16, 3.82 B parameters, random weights drawn on the card from
    ``seed``) served through the model-level loop (the engine refuses the
    family, as the reference's cannot serve it): 4 sequences of 576 patch
    embeddings and a 64-token prompt, one prefill (#1 at d 96 over the
    640-row stream), then 32 greedy decode steps (#7 at d 96), held to the
    plain path (``model_level_serve``) with every logit within ``atol`` =
    ``PHI3V_LOGIT_SPACINGS`` bf16 spacings at the largest |plain logit|,
    and each greedy token's plain logit within 2 ``atol`` of the plain
    maximum (what logits within ``atol`` of each other allow)."""
    from repro_torch.configs import get_config

    dev = torch.device("cuda")
    b, n_patch, n_prompt, steps, cap = PHI3V_SERVE
    cfg = dataclasses.replace(get_config(PHI3V), attn_impl="pallas",
                              use_decode_kernel=True)
    gen = torch.Generator(device=dev).manual_seed(seed + 13)
    patches = torch.randn(b, n_patch, cfg.frontend_dim, generator=gen,
                          device=dev)
    prompt = torch.randint(1, cfg.vocab_size, (b, n_prompt), generator=gen,
                           device=dev)
    rec, launches = model_level_serve(
        torch, seed, card, tag, cfg, {"patches": patches}, prompt, cap,
        steps, lambda top: PHI3V_LOGIT_SPACINGS * 2.0 ** (
            math.floor(math.log2(top)) - 7), str(cfg.num_layers),
        near_tie=lambda top, margin, atol: margin <= 2 * atol)
    rec.update(patches=n_patch)
    return rec, launches


def phi3v_train_phase(torch, seed: int, card: str) -> tuple[dict, dict]:
    """The published phi-3-vision-4.2b (bf16, remat, full depth) trained 6
    steps through ``make_train_step`` and the ``Trainer`` with patches in
    the batch (4 rows of 576 patch embeddings + 1472 ``SyntheticLM``
    tokens: 2048 positions, the reference's seq_len), AdamW with
    warmup_cosine(1e-3, 2, 6), clip 1.0 (``trainer_phase``; the train
    launcher refuses the family). Every step takes the same batch, which
    must be learnt: the losses must be finite and the last below the
    first."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.optim import adamw, warmup_cosine

    b, n_patch, n_text, steps = PHI3V_TRAIN
    cfg = dataclasses.replace(get_config(PHI3V), attn_impl="pallas")
    gen = torch.Generator(device="cuda").manual_seed(seed + 14)
    text = SyntheticLM(cfg.vocab_size, n_text, b, seed=seed).batch_at(0)
    batch = {"patches": torch.randn(b, n_patch, cfg.frontend_dim,
                                    generator=gen, device="cuda"),
             "tokens": text["tokens"], "loss_mask": text["loss_mask"]}
    rec, launches = trainer_phase(
        torch, seed, card, "train-phi3v", cfg, n_patch + n_text, b,
        lambda: adamw(warmup_cosine(1e-3, 2, steps)),
        "AdamW, warmup_cosine(1e-3, 2, 6), clip 1.0",
        batch_at=lambda step: batch)
    check(rec["losses"][-1] < rec["losses"][0],
          f"train-phi3v: the loss did not fall ({rec['losses']})")
    return rec, launches


# ---------------------------------------------------------------------------
# phase 17: tensor- and sequence-parallel serving, ranks sharing one card
# ---------------------------------------------------------------------------

# the parity meshes (sp, tp, sp strategy) of phase 17 at 2 and 4 ranks,
# and the two bf16 serves' (granite-3-2b, serve's traffic)
PARITY_MESHES = ((1, 2, None), (2, 1, "allgather"), (2, 1, "ring"),
                 (2, 2, "allgather"))
SERVE_TP_MESHES = {"serve_tp2": (1, 2, None), "serve_sp2": (2, 1, "allgather")}
# the teacher-forced logits of a bf16 tp/sp serve against tp=1's: within
# this many bf16 spacings at the row's top |logit| (PERF.md §6);
# a token may part from tp=1's only where tp=1's top-2 margin is within
# twice that
TP_LOGIT_SPACINGS = 16
# the bf16 serves' depth: 8 of granite's 40 layers (cut from 40 to keep the
# script's time, as ROADMAP's order says; the tp=1 reference runs as deep)
SERVE_TP_LAYERS = 8
RANKS_NOTE = "ranks sharing one card, collectives through host memory"


def _spacing(top: float) -> float:
    """One bf16 spacing at |top|."""
    return 2.0 ** (math.floor(math.log2(max(abs(top), 2 ** -60))) - 7)


def _teacher_batch(torch, prompts, outputs, dev):
    """One packed prefill of every request's prompt and its first 31 of 32
    generated tokens (``outputs``, by rid = index), and the rows whose
    logits predict each generated token."""
    toks, segs, rows, off = [], [], [], 0
    for i, p in enumerate(prompts):
        seq = p + outputs[i][:-1]
        toks += seq
        segs += [i] * len(seq)
        rows += [off + len(p) - 1 + j for j in range(len(outputs[i]))]
        off += len(seq)
    pad = (-off) % 64
    toks += [0] * pad
    segs += [-1] * pad
    return ({"tokens": torch.tensor([toks], device=dev),
             "segment_ids": torch.tensor([segs], dtype=torch.int32,
                                         device=dev)},
            torch.tensor(rows, device=dev))


def _tp_serve_rank(torch, job) -> dict:
    """One rank of serve-tp2 / serve-sp2: the weights drawn from the seed,
    the requests served once, cold (no warm-up serve), timed with the
    launch counters reset just before and read just after; then the
    teacher-forced logits along tp=1's tokens (``job["forced"]``) through
    the rank's shard model, brought back by rank 0."""
    from repro_torch.distributed.meshes import serve_mesh
    from repro_torch.models import build_model
    from repro_torch.serve import ServingEngine

    sp, tp, strategy = job["mesh"]
    mesh = serve_mesh(sp, tp, backend="gloo", device=job.get("device",
                                                              "cuda"))
    dev = mesh.device
    model = build_model(job["cfg"])
    params = model.init(torch.Generator(device=dev).manual_seed(job["seed"]),
                        device=dev)
    kw = dict(job["engine"], tp=tp, sp=sp, sp_strategy=strategy, mesh=mesh,
              device=dev)
    eng = ServingEngine(model, params, **kw)
    del params
    on_card = dev.type == "cuda"      # False only in a CPU rehearsal
    if on_card:
        release(torch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    t0 = time.perf_counter()
    outputs = _serve(eng, job["prompts"], 32, prime=False)
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated(dev) if on_card else None
    batch, rows = _teacher_batch(torch, job["prompts"], job["forced"], dev)
    with torch.inference_mode():
        _, logits = eng.shard_model.prefill_packed(eng.params, batch)
    return {"rank": mesh.rank, "coord": mesh.coord, "outputs": outputs,
            "wall_s": wall, "latency": eng.latency_stats(),
            "peak_memory_bytes": peak, "launches": launches,
            "prefix_hits": eng.prefix_hits, "step_census": eng.step_census,
            "cache_bytes": eng.per_shard_cache_bytes(),
            "forced_logits": (logits[0, rows].float().cpu()
                              if mesh.rank == 0 else None)}


def tp_rank(jobs: list) -> list:
    """What one spawned rank of phase 17 runs: the float32 parity runs
    (``launch.serve_rank``, TF32 off as in the parent) and the bf16 serves
    (``_tp_serve_rank``)."""
    import torch

    from repro_torch.distributed import launch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    use_io_model()
    return [launch.serve_rank(job["spec"]) if job["kind"] == "parity"
            else _tp_serve_rank(torch, job) for job in jobs]


def tp_serving_phase(torch, seed: int, card: str) -> tuple[dict, dict]:
    """Phase 17: the port's tensor- and sequence-parallel serving (DESIGN.md
    §13-§14) as SPMD ranks (``repro_torch.distributed``) that share the one
    H100 over a gloo group (NCCL refuses two ranks of one communicator on
    one device), every collective staged through host memory: so this
    phase measures correctness and the kernels' per-shard work, not the
    speed of collectives. One spawn for each world size (2 ranks and 4).

    * parity-tp: granite-3-2b at full width, 2 layers, float32, at tp=2,
      sp=2 (allgather and ring) and (sp 2, tp 2), held to the tp=1 engine
      on the card: greedy tokens identical, packed-prefill logits within
      1e-4, each step kind's census exact on every rank;
    * serve-tp2 and serve-sp2 (allgather): granite-3-2b in bf16 at full
      width, ``SERVE_TP_LAYERS`` deep, serve's traffic, against the tp=1
      serve on the card: every rank's tokens identical; teacher-forced logits along
      tp=1's tokens within ``TP_LOGIT_SPACINGS`` bf16 spacings of tp=1's,
      a token parting from tp=1's only at a top-2 margin within twice
      that; #1 (at tp only), #4 and #8 launched on every rank; tok/s, TTFT
      p50 and per-rank peak memory of one cold serve (the warm-up serve
      that captured rank 0's kernel calls was cut to keep the script's
      time).

    Returns ({"parity_tp", "spawn_s", path: record}, {path: rank 0's
    launches})."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import launch
    from repro_torch.distributed.sharding import expected_sp_prefill_census
    from repro_torch.models import build_model
    from repro_torch.serve import ServingEngine

    dev = torch.device("cuda")
    # float32 parity at 2 layers: the tp=1 engine on the card
    pcfg = dataclasses.replace(get_config("granite-3-2b"), num_layers=2,
                               dtype="float32", attn_impl="pallas",
                               use_decode_kernel=True)
    gen = torch.Generator().manual_seed(seed + 1)

    def ptoks(n):
        return torch.randint(1, pcfg.vocab_size, (n,), generator=gen).tolist()

    shared = ptoks(32)
    pprompts = [shared + ptoks(9), ptoks(150), shared + ptoks(20),
                shared + ptoks(3), ptoks(40)]
    waves = [[{"prompt": pprompts[0], "max_new": 12}],
             [{"prompt": p, "max_new": 12} for p in pprompts[1:]]]
    pkw = dict(num_slots=4, capacity=256, page_size=16, chunk_size=64)
    n1, n2 = len(pprompts[1]), len(pprompts[2])
    live, pad = n1 + n2, (-(n1 + n2)) % 64
    packed = {"tokens": torch.tensor([pprompts[1] + pprompts[2] + [0] * pad]),
              "segment_ids": torch.tensor([[0] * n1 + [1] * n2 + [-1] * pad],
                                          dtype=torch.int32)}
    pmodel = build_model(pcfg)
    pparams = pmodel.init(torch.Generator(device=dev).manual_seed(seed),
                          device=dev)
    eng = ServingEngine(pmodel, pparams, device=dev, **pkw)
    want = launch.serve_waves(eng, waves)
    check(eng.prefix_hits >= 1, "parity-tp: the tp=1 run had no prefix hit")
    with torch.inference_mode():
        _, want_logits = pmodel.prefill_packed(
            pparams, {k: v.to(dev) for k, v in packed.items()})
    want_logits = want_logits.cpu()
    del eng, pparams
    release(torch)

    # bf16 at SERVE_TP_LAYERS: the tp=1 serve of serve's traffic on the
    # card, and its teacher-forced logits along its own tokens
    cfg = dataclasses.replace(get_config("granite-3-2b"), attn_impl="pallas",
                              use_decode_kernel=True,
                              num_layers=SERVE_TP_LAYERS)
    gen = torch.Generator().manual_seed(seed + 2)

    def toks(n):
        return torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist()

    toks(300)                        # serve's warm-up prompt: same traffic
    shared = toks(64)
    prompts = [shared + toks(1024 - 64)] + [shared + toks(n) for n in
                                            (17, 120, 45, 200, 9, 77, 150)]
    kw = dict(num_slots=4, capacity=1056, page_size=16, chunk_size=256)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(seed),
                        device=dev)
    _serve(ServingEngine(model, params, device=dev, **kw), prompts[:2], 4,
           prime=False)                                    # warm-up
    eng = ServingEngine(model, params, device=dev, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    forced = _serve(eng, prompts, 32, prime=False)
    torch.cuda.synchronize()
    tp1 = {"wall_s": time.perf_counter() - t0, "latency": eng.latency_stats(),
           "cache_bytes": eng.cache_bytes()}
    forced = [forced[i] for i in range(len(prompts))]
    batch, rows = _teacher_batch(torch, prompts, forced, dev)
    with torch.inference_mode():
        _, lg = model.prefill_packed(params, batch)
    tp1_logits = lg[0, rows].float().cpu()
    del eng, params, lg
    release(torch)
    print(f"[serve-tp1] granite-3-2b {cfg.num_layers} layers bf16, one process: "
          f"{32 * len(prompts) / tp1['wall_s']:.1f} tok/s, TTFT p50 "
          f"{tp1['latency']['ttft_p50'] * 1e3:.1f} ms [{card}]", flush=True)

    def parity_job(mesh):
        sp, tp, strategy = mesh
        return {"kind": "parity", "spec": {
            "cfg": pcfg, "params": None, "seed": seed, "device": "cuda",
            "backend": "gloo", "runs": [{
                "sp": sp, "tp": tp, "sp_strategy": strategy, "engine": pkw,
                "waves": waves, "packed": {k: v.numpy()
                                           for k, v in packed.items()}}]}}

    # one spawn for each world size, its parity runs and its serves
    jobs = [("parity", m, parity_job(m)) for m in PARITY_MESHES] + [
        (path, mesh, {"kind": "serve", "mesh": mesh, "cfg": cfg,
                      "seed": seed, "engine": kw, "prompts": prompts,
                      "forced": forced})
        for path, mesh in SERVE_TP_MESHES.items()]
    results = {}
    t0 = time.perf_counter()
    for world in sorted({m[0] * m[1] for _, m, _ in jobs}):
        mine = [j for j in jobs if j[1][0] * j[1][1] == world]
        out = launch.spawn(world, tp_rank, [job for _, _, job in mine],
                           threads=2)
        for k, (name, mesh, _) in enumerate(mine):
            results[(name, mesh)] = [r[k] for r in out]
    spawn_s = time.perf_counter() - t0

    L = pcfg.num_layers
    parity = []
    for mesh in PARITY_MESHES:
        sp, tp, strategy = mesh
        recs = [r[0] for r in results[("parity", mesh)]]
        census = ({"all_reduce": 2 * L} if sp == 1 else
                  expected_sp_prefill_census(L, sp=sp, strategy=strategy))
        want_census = ({"prefill_zero": census, "prefill_chunk": census,
                        "decode": census} if sp == 1 else
                       {"prefill_chunk": census,
                        "decode": {"all_reduce": 2 * L}})
        err = max(float((torch.from_numpy(r["packed_logits"][:, :live])
                         - want_logits[:, :live]).abs().max()) for r in recs)
        tag = f"parity-tp sp={sp} tp={tp}" + (f" {strategy}" if sp > 1 else "")
        for r in recs:
            check(r["outputs"] == want,
                  f"{tag}: rank {r['rank']}'s greedy tokens differ from the "
                  f"tp=1 engine's")
            check(r["step_census"] == want_census,
                  f"{tag}: rank {r['rank']}'s census {r['step_census']} is "
                  f"not {want_census}")
        check(err <= 1e-4, f"{tag}: packed-prefill logits {err} from tp=1's")
        print(f"[{tag}] granite-3-2b 2 layers float32, {sp * tp} ranks: greedy "
              f"tokens identical to tp=1 ({len(want)} requests), packed "
              f"prefill max |logit - tp=1| {err:.3g}, census {census} on "
              f"every rank [{card}; {RANKS_NOTE}]", flush=True)
        parity.append({"sp": sp, "tp": tp, "strategy": strategy,
                       "identical": True, "max_abs_logit_err": err,
                       "census": want_census, "prefix_hits":
                       recs[0]["prefix_hits"]})

    out, launches = {"parity_tp": parity, "spawn_s": spawn_s}, {}
    n_tok = 32 * len(prompts)
    for path, (sp, tp, strategy) in SERVE_TP_MESHES.items():
        tag = path.replace("_", "-")
        recs = results[(path, (sp, tp, strategy))]
        r0 = recs[0]
        for r in recs:
            check(r["outputs"] == r0["outputs"],
                  f"{tag}: rank {r['rank']}'s tokens differ from rank 0's")
            for name in SERVE_KERNELS:
                if name == "flash_fwd_sm90" and tp == 1:
                    continue
                check(r["launches"][name] > 0,
                      f"{tag}: kernel {name} never launched on rank "
                      f"{r['rank']}")
        fl = r0["forced_logits"]
        diffs, divergences = [], []
        for i in range(len(prompts)):
            for j in range(32):
                top = float(tp1_logits[i * 32 + j].abs().max())
                d = float((fl[i * 32 + j] - tp1_logits[i * 32 + j]).abs().max())
                diffs.append(d / _spacing(top))
            got, ref = r0["outputs"][i], forced[i]
            if got != ref:
                j = next(n for n, (a, b) in enumerate(zip(got, ref)) if a != b)
                row = tp1_logits[i * 32 + j]
                margin = float(row[ref[j]] - row[got[j]])
                spc = margin / _spacing(float(row.abs().max()))
                divergences.append({"rid": i, "step": j, "margin": margin,
                                    "spacings": spc})
                check(spc <= 2 * TP_LOGIT_SPACINGS,
                      f"{tag}: request {i} parts from tp=1 at step {j} with "
                      f"a top-2 margin of {spc:.3g} bf16 spacings")
        check(max(diffs) <= TP_LOGIT_SPACINGS,
              f"{tag}: teacher-forced logits {max(diffs):.3g} bf16 spacings "
              f"from tp=1's (limit {TP_LOGIT_SPACINGS})")
        lat = r0["latency"]
        rec = {"model": cfg.name, "layers": cfg.num_layers, "dtype": cfg.dtype,
               "sp": sp, "tp": tp, "strategy": strategy, "requests":
               len(prompts), "new_tokens": n_tok, "wall_s": r0["wall_s"],
               "tokens_per_s": n_tok / r0["wall_s"],
               "ttft_p50_s": lat["ttft_p50"],
               "tok_latency_p50_s": lat["tok_latency_p50"],
               "peak_memory_bytes_by_rank": [r["peak_memory_bytes"]
                                             for r in recs],
               "cache_bytes_by_rank": [r["cache_bytes"] for r in recs],
               "tp1": tp1, "launches_by_rank": [
                   {n: r["launches"][n] for n in SERVE_KERNELS}
                   for r in recs],
               "census_by_rank": [r["step_census"] for r in recs],
               "max_forced_logit_spacings": max(diffs),
               "divergences": divergences, "prefix_hits": r0["prefix_hits"],
               "card": card, "note": RANKS_NOTE}
        out[path] = rec
        launches[path] = r0["launches"]
        print(f"[{tag}] granite-3-2b {cfg.num_layers} layers bf16, sp={sp} tp={tp}: "
              f"{n_tok} tokens in {r0['wall_s']:.2f}s ({n_tok / r0['wall_s']:.1f}"
              f" tok/s, TTFT p50 {lat['ttft_p50'] * 1e3:.1f} ms), peak memory "
              f"by rank {[round(r['peak_memory_bytes'] / 2**30, 2) for r in recs]}"
              f" GiB, pool {r0['cache_bytes'] / 2**20:.0f} MiB a rank (tp=1: "
              f"{tp1['cache_bytes'] / 2**20:.0f}), every rank's tokens "
              f"identical; teacher-forced logits within "
              f"{max(diffs):.3g} bf16 spacings of tp=1's (limit "
              f"{TP_LOGIT_SPACINGS}), {len(divergences)} requests part from "
              f"tp=1 at margins {[round(d['spacings'], 2) for d in divergences]}"
              f" spacings; launches by rank {rec['launches_by_rank']} "
              f"[{card}; {RANKS_NOTE}]", flush=True)
    print(f"[tp-serving] the spawns in {spawn_s:.1f}s", flush=True)
    return out, launches


# ---------------------------------------------------------------------------
# phase 18: sharded training, ranks sharing one card
# ---------------------------------------------------------------------------

# parity-train-mesh: granite-3-2b at full width, 2 layers, float32, 3 AdamW
# steps at these meshes ((data, model), ZeRO-1) against the single-rank
# step on the card; losses within TRAIN_MESH_RTOL
# (the data-4 mesh without ZeRO-1 was cut to keep the script under 950 s,
# after phase 22's paged serve, as ROADMAP's order says)
PARITY_TRAIN_MESHES = (((2, 2), True),)
PARITY_TRAIN = (256, 4, 3)                # seq, global batch, steps
TRAIN_MESH_RTOL = 1e-4
# train-dp2tp2: granite-3-2b at full width, 2 of 40 layers (cut to keep the
# script under 950 s), bf16, seq 2048,
# global batch 4 (2 rows a data rank), ZeRO-1, 4 AdamW steps of the
# launcher's recipe on its batches; each step's loss within this relative
# bound of the single-rank bf16 step's (PERF.md §6, set before the first
# card run)
DP2TP2 = ((2, 2), 2, 2048, 4, 4)          # mesh, layers, seq, batch, steps
DP2TP2_LOSS_RTOL = 2e-3
# pipeline-2: two 2-stage pipelines (the "pipe" axis of a (2, 2) mesh) of
# the reference's residual tanh layers, fp32 on the card
PIPELINE_2 = (8, 512, 16, 4)              # layers, width, global batch, M


def train_mesh_kernel_phase(torch, seed: int) -> dict:
    """#1/#2/#3 at train-dp2tp2's rank 0 layer (2 rows of the launcher's
    first batch, its documents, 16 q / 4 kv heads of 64, causal) and at
    train-ep4's (olmoe-1b-7b: 4 rows, 4 / 4 heads of 128) through
    ``fwd_bwd_case``, early in the script (the profiler records whole
    windows in a young process). Returns {kernel: {"train_dp2tp2": entry,
    "train_ep4": entry}}."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM

    out: dict = {}
    for path, arch, ((data_ranks, model_ranks), _, seq, batch, _), k in (
            ("train_dp2tp2", "granite-3-2b", DP2TP2, 30),
            ("train_ep4", TRAIN_EP4[0], TRAIN_EP4[1:], 31)):
        cfg = get_config(arch)
        rows = batch // data_ranks
        seg = torch.as_tensor(SyntheticLM(cfg.vocab_size, seq, batch,
                                          seed=seed).batch_at(0)
                              ["segment_ids"][:rows]).to("cuda")
        gen = torch.Generator(device="cuda").manual_seed(seed + k)
        c = fwd_bwd_case(torch, gen, rows, cfg.num_heads // model_ranks,
                         cfg.num_kv_heads // model_ranks, seq, cfg.head_dim,
                         True, seg)
        for name, e in shape_entries(c).items():
            out.setdefault(name, {})[path] = e
    return out


def train_mesh_rank(jobs: list) -> list:
    """What one spawned rank of phase 18 runs: the train runs
    (``launch.train_rank``) and the pipeline (``launch.pipeline_rank``),
    TF32 off as in the parent."""
    import torch

    from repro_torch.distributed import launch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = []
    for job in jobs:
        out.append(launch.train_rank(job["spec"]) if job["kind"] == "train"
                   else launch.pipeline_rank(job["spec"]))
        release(torch)
    return out


def _single_rank_losses(torch, cfg, seed, batches, opt) -> tuple[list, float]:
    """The single-rank ``make_train_step`` on the card over ``batches``:
    its losses and its mean ms a step over steps 2 on."""
    from repro_torch.models import build_model
    from repro_torch.train import make_train_step

    dev = torch.device("cuda")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(seed),
                        device=dev)
    state = opt.init(params)
    step = make_train_step(model, opt, deterministic=True)
    losses, times = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, b)
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
    del params, state
    release(torch)
    return losses, sum(times[1:]) / max(len(times) - 1, 1) * 1e3


def train_mesh_phase(torch, seed: int, card: str) -> tuple[dict, dict]:
    """Phase 18: the port's sharded training (``train.steps.
    make_sharded_train_step``) as SPMD ranks (``repro_torch.distributed``)
    that share the one H100 over a gloo group, every collective staged
    through host memory (NCCL refuses two ranks of one communicator on one
    device): so this phase measures correctness and the kernels'
    per-rank work, not the speed of collectives. One spawn of 4 ranks.

    * parity-train-mesh: granite-3-2b at full width, 2 layers, float32,
      at data 2 x model 2 with ZeRO-1, 3 AdamW steps
      against the single-rank ``make_train_step`` on the card: losses
      within ``TRAIN_MESH_RTOL``, every rank's census of every step the
      ``expected_train_census``;
    * train-dp2tp2: granite-3-2b at full width, 2 of 40 layers, bf16,
      seq 2048, global batch 4, ZeRO-1, 4 steps of the launcher's recipe
      on its batches, #1, #2 and #3 at 16 q / 4 kv heads a rank: losses
      within ``DP2TP2_LOSS_RTOL`` of the single-rank bf16 step's, ms a
      step, each rank's peak memory, the step's collectives by kind and
      each rank's launches (every attention kernel on every rank; the
      kernels are held at rank 0's shapes early, ``train_mesh_kernel_phase``);
    * pipeline-2: ``pipeline_apply`` over 2 stages (two pipelines, the
      "pipe" axis of a (2, 2) mesh) on CUDA tensors against the
      sequential stack on the card, forward and gradients.

    Returns (record, {path: rank 0's launches})."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.distributed import launch
    from repro_torch.distributed.pipeline import tanh_block
    from repro_torch.optim import adamw, warmup_cosine

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # -- parity-train-mesh: the single-rank step on the card --------------
    pcfg = dataclasses.replace(get_config("granite-3-2b"), num_layers=2,
                               dtype="float32", attn_impl="pallas")
    pseq, pbatch, psteps = PARITY_TRAIN
    data = SyntheticLM(pcfg.vocab_size, pseq, pbatch, seed=seed)
    pbatches = [data.batch_at(i) for i in range(psteps)]
    popt = {"name": "adamw", "lr": 1e-3}
    want, _ = _single_rank_losses(torch, pcfg, seed, pbatches, adamw(1e-3))

    # -- train-dp2tp2: the single-rank bf16 step, the kernels at rank 0's
    # shapes -------------------------------------------------------------
    mesh, layers, seq, batch, steps = DP2TP2
    cfg = dataclasses.replace(get_config("granite-3-2b"), num_layers=layers,
                              attn_impl="pallas")
    data = SyntheticLM(cfg.vocab_size, seq, batch, seed=seed)
    batches = [data.batch_at(i) for i in range(steps)]
    tp1, tp1_ms = _single_rank_losses(
        torch, cfg, seed, batches, adamw(warmup_cosine(3e-4, 20, steps)))

    # -- pipeline-2 inputs and the sequential stack on the card ------------
    L, D, GB, M = PIPELINE_2
    g = torch.Generator().manual_seed(seed + 40)
    w = torch.randn((L, D, D), generator=g) * (0.3 / math.sqrt(D / 16))
    x = torch.randn((GB, D), generator=g)
    wt = w.to(dev).requires_grad_()
    y = x.to(dev)
    for l in range(L):
        y = tanh_block({"w": wt[l]}, y)
    y.square().sum().backward()
    seq_y, seq_g = y.detach().cpu(), wt.grad.cpu()
    del wt, y

    def spec(runs):
        return {"backend": "gloo", "device": "cuda", "seed": seed,
                "runs": runs}

    jobs = [{"kind": "train", "spec": spec([
        {"cfg": pcfg, "shape": shape, "zero1": zero1, "optimizer": popt,
         "batches": pbatches} for shape, zero1 in PARITY_TRAIN_MESHES])},
        {"kind": "train", "spec": spec([
            {"cfg": cfg, "shape": mesh, "zero1": True, "batches": batches,
             "optimizer": {"name": "adamw",
                           "lr": ("warmup_cosine", (3e-4, 20, steps))}}])},
        {"kind": "pipeline", "spec": {
            "w": w.numpy(), "x": x.numpy(), "num_microbatches": M,
            "shape": (2, 2), "axes": ("data", "pipe"), "device": "cuda",
            "backend": "gloo"}}]
    t0 = time.perf_counter()
    out = launch.spawn(4, train_mesh_rank, jobs, threads=2)
    spawn_s = time.perf_counter() - t0

    # -- parity-train-mesh ------------------------------------------------
    parity = []
    for k, (shape, zero1) in enumerate(PARITY_TRAIN_MESHES):
        recs = [r[0][k] for r in out]
        tag = (f"parity-train-mesh data {shape[0]} x model {shape[1]}"
               + (" ZeRO-1" if zero1 else ""))
        got = [h["loss"] for h in recs[0]["history"]]
        err = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        for r in recs:
            check([h["loss"] for h in r["history"]] == got,
                  f"{tag}: rank {r['rank']}'s losses differ from rank 0's")
            for i, census in enumerate(r["census"]):
                check(census == r["expected_census"],
                      f"{tag}: rank {r['rank']} step {i + 1} census {census}"
                      f" is not {r['expected_census']}")
        check(err <= TRAIN_MESH_RTOL,
              f"{tag}: losses {got} are {err:.3g} relative from the single "
              f"rank's {want}")
        print(f"[{tag}] granite-3-2b 2 layers float32, {psteps} AdamW steps "
              f"at seq {pseq} x batch {pbatch}: losses {got} within "
              f"{err:.3g} relative of the single rank's {want}; census "
              f"{recs[0]['expected_census']} on every rank, every step "
              f"[{card}; {RANKS_NOTE}]", flush=True)
        parity.append({"shape": shape, "zero1": zero1, "losses": got,
                       "single_rank": want, "max_rel_err": err,
                       "census": recs[0]["expected_census"]})

    # -- train-dp2tp2 ------------------------------------------------------
    recs = [r[1][0] for r in out]
    r0 = recs[0]
    got = [h["loss"] for h in r0["history"]]
    errs = [abs(a - b) / abs(b) for a, b in zip(got, tp1)]
    for r in recs:
        check([h["loss"] for h in r["history"]] == got,
              f"train-dp2tp2: rank {r['rank']}'s losses differ from rank 0's")
        for i, census in enumerate(r["census"]):
            check(census == r["expected_census"],
                  f"train-dp2tp2: rank {r['rank']} step {i + 1} census "
                  f"{census} is not {r['expected_census']}")
        for name in TRAIN_KERNELS:
            check(r["launches"][name] > 0,
                  f"train-dp2tp2: kernel {name} never launched on rank "
                  f"{r['rank']}")
        for name in MMA_BODIES:
            check(r["launches"][name] == 0,
                  f"train-dp2tp2: the mma.sync body {name} ran on rank "
                  f"{r['rank']}")
    check(all(math.isfinite(v) for v in got), f"train-dp2tp2: losses {got}")
    check(max(errs) <= DP2TP2_LOSS_RTOL,
          f"train-dp2tp2: losses {got} are {max(errs):.3g} relative from "
          f"the single rank's {tp1} (bound {DP2TP2_LOSS_RTOL})")
    step_ms = [h["step_time_s"] * 1e3 for h in r0["history"]]
    ms = sum(step_ms[1:]) / (len(step_ms) - 1)
    rec = {"model": cfg.name, "layers": layers, "dtype": cfg.dtype,
           "mesh": mesh, "zero1": True, "seq": seq, "batch": batch,
           "steps": steps, "losses": got, "single_rank": tp1,
           "max_rel_err": max(errs), "bound": DP2TP2_LOSS_RTOL,
           "step_ms": step_ms, "ms_per_step": ms,
           "tokens_per_s": seq * batch / (ms / 1e3),
           "single_rank_ms_per_step": tp1_ms,
           "peak_memory_bytes_by_rank": [r["peak_memory_bytes"] for r in recs],
           "census": r0["expected_census"],
           "launches_by_rank": [{n: r["launches"][n] for n in TRAIN_KERNELS}
                                for r in recs],
           "card": card, "note": RANKS_NOTE}
    print(f"[train-dp2tp2] granite-3-2b {layers} layers bf16, data "
          f"{mesh[0]} x model {mesh[1]} ZeRO-1, seq {seq} x batch {batch}, "
          f"{steps} steps: losses {got} within {max(errs):.3g} relative of "
          f"the single rank's {tp1} (bound {DP2TP2_LOSS_RTOL}); {ms:.1f} ms "
          f"a step over steps 2-{steps} (single rank {tp1_ms:.1f} ms); peak "
          f"memory by rank "
          f"{[round(r['peak_memory_bytes'] / 2**30, 2) for r in recs]} GiB; "
          f"a step's collectives {r0['expected_census']}; launches by rank "
          f"{rec['launches_by_rank']} [{card}; {RANKS_NOTE}]", flush=True)

    # -- pipeline-2 --------------------------------------------------------
    prec = [r[2] for r in out]
    y_err = max(float((torch.from_numpy(r["y"]) - seq_y).abs().max())
                for r in prec)
    pipes = {}
    for r in prec:           # the two pipelines' gradients, each summed
        pipes.setdefault(r["rank"] // 2, []).append(torch.from_numpy(r["grad"]))
    g_err = max(float((sum(gs) - seq_g).abs().max() / seq_g.abs().max())
                for gs in pipes.values())
    check(y_err <= 1e-4 * float(seq_y.abs().max()) + 1e-5,
          f"pipeline-2: max |y - sequential| {y_err}")
    check(g_err <= 1e-4, f"pipeline-2: gradient scaled error {g_err}")
    print(f"[pipeline-2] {L} layers of width {D}, batch {GB} in {M} "
          f"microbatches over 2 stages (two pipelines) on the card: max |y - "
          f"sequential| {y_err:.3g}, gradients' scaled error {g_err:.3g}; "
          f"collectives a rank {prec[0]['census']} [{card}; {RANKS_NOTE}]",
          flush=True)
    print(f"[train-mesh] the spawn in {spawn_s:.1f}s", flush=True)
    return ({"parity_train_mesh": parity, "train_dp2tp2": rec,
             "pipeline_2": {"layers": L, "width": D, "batch": GB,
                            "microbatches": M, "max_abs_err": y_err,
                            "grad_scaled_err": g_err,
                            "census": prec[0]["census"]},
             "spawn_s": spawn_s},
            {"train_dp2tp2": {n: r0["launches"].get(n, 0)
                              for n in read_launches()}})


# ---------------------------------------------------------------------------
# phase 19: every family trained with a "model" axis above one
# ---------------------------------------------------------------------------

# parity-train-family: (arch, (data, model), ZeRO-1), each at full width, 2
# layers (seamless 2 + 2), float32, PARITY_TRAIN's 3 AdamW steps against
# the single rank on the card, losses within TRAIN_MESH_RTOL (olmoe's data
# 2 x model 2 ZeRO-1 mesh and mamba2-2.7b's model 4 were cut to keep the
# script's time, after phase 22's paged serve and phase 18's data-4 mesh,
# as ROADMAP's order says); seamless's is the encoder-decoder's only run
# with a "model" axis and the phase's only ZeRO-1 mesh
PARITY_FAMILY = (("olmoe-1b-7b", (1, 4), False),
                 ("phi-3-vision-4.2b", (1, 4), False),
                 ("seamless-m4t-medium", (2, 2), True))
PARITY_FAMILY_TEXT = {"phi-3-vision-4.2b": 64,      # tokens after 576 patches
                      "seamless-m4t-medium": 128}   # tokens after 256 frames
# train-ep4 / train-ssm-tp4: arch, (data, model), layers, seq, batch, steps,
# bf16, the launcher's recipe; losses within DP2TP2_LOSS_RTOL of the single
# rank's (the prediction in PERF.md §6, set before the first card run)
TRAIN_EP4 = ("olmoe-1b-7b", (1, 4), 1, 2048, 4, 4)
TRAIN_SSM_TP4 = ("mamba2-2.7b", (1, 4), 2, 2048, 4, 4)


def family_batches(cfg, seq: int, batch: int, steps: int, seed: int) -> list:
    """numpy batches of ``SyntheticLM``'s tokens for ``cfg``'s family: a
    VLM's 576 patches ahead of PARITY_FAMILY_TEXT tokens, an
    encoder-decoder's ``seq`` audio frames beside them (neither takes
    segment ids), else ``seq`` tokens with their documents."""
    import numpy as np

    from repro_torch.data import SyntheticLM

    n_text = PARITY_FAMILY_TEXT.get(cfg.name, seq)
    data = SyntheticLM(cfg.vocab_size, n_text, batch, seed=seed)
    rng = np.random.default_rng(seed + 19)
    out = []
    for i in range(steps):
        b = dict(data.batch_at(i))
        if cfg.frontend is not None:
            del b["segment_ids"]
            rows = cfg.frontend_tokens if cfg.frontend == "vision" else seq
            key = "patches" if cfg.frontend == "vision" else "frames"
            b[key] = rng.standard_normal(
                (batch, rows, cfg.frontend_dim)).astype(np.float32)
        out.append(b)
    return out


def _census_checked(tag: str, recs: list) -> list:
    """Every rank's losses rank 0's and each step's census the expected;
    returns rank 0's losses."""
    got = [h["loss"] for h in recs[0]["history"]]
    for r in recs:
        check([h["loss"] for h in r["history"]] == got,
              f"{tag}: rank {r['rank']}'s losses differ from rank 0's")
        for i, census in enumerate(r["census"]):
            check(census == r["expected_census"],
                  f"{tag}: rank {r['rank']} step {i + 1} census {census} is "
                  f"not {r['expected_census']}")
    return got


def train_family_phase(torch, seed: int, card: str) -> tuple[dict, dict]:
    """Phase 19: every family trained with a "model" axis above one
    (``make_sharded_train_step``: the MoE's experts, the SSM by head group,
    the encoder-decoder's and the VLM's heads cut over "model") as four
    gloo ranks sharing the card in one spawn, collectives staged through
    host memory (so this phase measures correctness and each rank's work,
    not the speed of collectives).

    * parity-train-family: ``PARITY_FAMILY`` at full width, 2 layers,
      float32, 3 AdamW steps against the single-rank step on the card:
      losses within ``TRAIN_MESH_RTOL``, the MoE's routes at every call of
      a step's forward held to a forward from the same weights (step 1:
      the single rank's; every later step: one forward of the whole model
      on rank 0 with the mesh's weights of that step gathered, over the
      step's tokens), a flip only at a near-tie (gap <= ``ROUTE_TIE``),
      every rank's census of every step the expected;
    * train-ep4 / train-ssm-tp4: olmoe-1b-7b (1 layer, 16 experts and
      4 / 4 heads of 128 a rank) and mamba2-2.7b (2 layers, 20 SSM heads a
      rank) at model 4 in bf16, 4 steps of the launcher's recipe at seq
      2048 x 4: losses within ``DP2TP2_LOSS_RTOL`` of the single-rank bf16
      step's, ms a step, peak memory, collectives and launches by rank.

    Returns (record, {"train_ep4": rank 0's launches})."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.distributed import launch
    from repro_torch.optim import adamw, warmup_cosine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    pseq, pbatch, psteps = PARITY_TRAIN
    # -- parity-train-family: the single rank on the card ------------------
    pcfgs, pbatches, want = {}, {}, {}
    for arch, _, _ in PARITY_FAMILY:
        if arch in pcfgs:
            continue
        cfg = dataclasses.replace(get_config(arch), num_layers=2,
                                  dtype="float32", attn_impl="pallas")
        if cfg.num_encoder_layers:
            cfg = dataclasses.replace(cfg, num_encoder_layers=2)
        pcfgs[arch] = cfg
        pbatches[arch] = family_batches(cfg, pseq, pbatch, psteps, seed)
        with watch_routes() as seen:
            losses, _ = _single_rank_losses(torch, cfg, seed, pbatches[arch],
                                            adamw(1e-3))
        want[arch] = (losses, list(seen))
    # -- train-ep4 / train-ssm-tp4: the single-rank bf16 steps -------------
    trains = {}
    for tag, (arch, mesh, layers, seq, batch, steps) in (
            ("train-ep4", TRAIN_EP4), ("train-ssm-tp4", TRAIN_SSM_TP4)):
        cfg = dataclasses.replace(get_config(arch), num_layers=layers,
                                  attn_impl="pallas")
        data = SyntheticLM(cfg.vocab_size, seq, batch, seed=seed)
        batches = [data.batch_at(i) for i in range(steps)]
        one, one_ms = _single_rank_losses(
            torch, cfg, seed, batches, adamw(warmup_cosine(3e-4, 20, steps)))
        trains[tag] = (cfg, mesh, batches, one, one_ms)

    runs = [{"cfg": pcfgs[arch], "shape": shape, "zero1": zero1,
             "optimizer": {"name": "adamw", "lr": 1e-3},
             "batches": pbatches[arch],
             "routes": pcfgs[arch].family == "moe",
             "step_routes": pcfgs[arch].family == "moe"}
            for arch, shape, zero1 in PARITY_FAMILY]
    runs += [{"cfg": cfg, "shape": mesh, "zero1": True, "batches": batches,
              "optimizer": {"name": "adamw",
                            "lr": ("warmup_cosine", (3e-4, 20,
                                                     len(batches)))}}
             for cfg, mesh, batches, _, _ in trains.values()]
    jobs = [{"kind": "train", "spec": {"backend": "gloo", "device": "cuda",
                                       "seed": seed, "runs": runs}}]
    single_s = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    out = launch.spawn(4, train_mesh_rank, jobs, threads=2)
    spawn_s = time.perf_counter() - t0

    # -- parity-train-family ----------------------------------------------
    parity = []
    for k, (arch, shape, zero1) in enumerate(PARITY_FAMILY):
        recs = [r[0][k] for r in out]
        tag = (f"parity-train-family {arch} data {shape[0]} x model "
               f"{shape[1]}" + (" ZeRO-1" if zero1 else ""))
        got = _census_checked(tag, recs)
        losses, seen = want[arch]
        err = max(abs(a - b) / abs(b) for a, b in zip(got, losses))
        check(err <= TRAIN_MESH_RTOL,
              f"{tag}: losses {got} are {err:.3g} relative from the single "
              f"rank's {losses}")
        first, later = [], {}
        if "routes" in recs[0]:
            per_step = len(seen) // psteps
            layers = pcfgs[arch].num_layers
            gathered = recs[0]["step_routes"]
            check(len(gathered) == psteps - 1,
                  f"{tag}: {len(gathered)} gathered forwards, not "
                  f"{psteps - 1}")
            for r in recs:
                rows = pbatch // shape[0]
                b0 = r["coord"]["data"] * rows
                check(len(r["routes"]) == len(seen),
                      f"{tag}: rank {r['rank']} routed {len(r['routes'])} "
                      f"times, the single rank {len(seen)}")
                # step 1 against the single rank (the same weights); every
                # later step against one forward of the mesh's own weights,
                # gathered onto rank 0, over that step's tokens: the
                # step's first ``layers`` calls are its forward
                f, _ = route_differences(
                    [(torch.from_numpy(i), None)
                     for i in r["routes"][:layers]],
                    [(i[b0:b0 + rows], p[b0:b0 + rows])
                     for i, p in seen[:layers]], rows_apart=True)
                first += [dict(x, rank_of_mesh=r["rank"]) for x in f]
                for k, calls in enumerate(gathered, start=1):
                    mine = r["routes"][k * per_step:k * per_step + layers]
                    f, _ = route_differences(
                        [(torch.from_numpy(i), None) for i in mine],
                        [(torch.from_numpy(i[b0:b0 + rows]),
                          torch.from_numpy(p[b0:b0 + rows]))
                         for i, p in calls], rows_apart=True)
                    later.setdefault(k + 1, []).extend(
                        dict(x, rank_of_mesh=r["rank"]) for x in f)
            check(all(x["gap"] <= ROUTE_TIE for x in first),
                  f"{tag}: step 1's route flips {first} are not all "
                  f"near-ties (gap <= {ROUTE_TIE}); losses {got}, the single "
                  f"rank's {losses}")
            for k, flips in later.items():
                check(all(x["gap"] <= ROUTE_TIE for x in flips),
                      f"{tag}: step {k}'s route flips against the mesh's own "
                      f"gathered weights {flips} are not all near-ties (gap "
                      f"<= {ROUTE_TIE})")
        steps_note = "; ".join(
            f"step {k} {len(v)} (largest gap "
            f"{max((x['gap'] for x in v), default=0.0):.3g})"
            for k, v in later.items())
        print(f"[{tag}] full width, 2 layers float32, {psteps} AdamW steps: "
              f"losses {got} within {err:.3g} relative of the single rank's "
              f"{losses}; route flips at step 1 against the single rank "
              f"{len(first)} (largest gap "
              f"{max((x['gap'] for x in first), default=0.0):.3g}), against "
              f"the mesh's gathered weights: {steps_note or 'none routed'} "
              f"(each <= {ROUTE_TIE}); census"
              f" {recs[0]['expected_census']} on every rank, every step "
              f"[{card}; {RANKS_NOTE}]", flush=True)
        parity.append({"arch": arch, "shape": shape, "zero1": zero1,
                       "losses": got, "single_rank": losses,
                       "max_rel_err": err, "route_flips_step1": first,
                       "route_flips_by_step": later,
                       "census": recs[0]["expected_census"]})

    # -- train-ep4 / train-ssm-tp4 -----------------------------------------
    record = {"parity_train_family": parity, "spawn_s": spawn_s,
              "single_rank_s": single_s}
    kernels = {"train-ep4": TRAIN_KERNELS, "train-ssm-tp4": ()}
    for j, (tag, (cfg, mesh, batches, one, one_ms)) in enumerate(
            trains.items()):
        recs = [r[0][len(PARITY_FAMILY) + j] for r in out]
        r0 = recs[0]
        got = _census_checked(tag, recs)
        errs = [abs(a - b) / abs(b) for a, b in zip(got, one)]
        for r in recs:
            for name in kernels[tag]:
                check(r["launches"][name] > 0,
                      f"{tag}: kernel {name} never launched on rank "
                      f"{r['rank']}")
            for name in MMA_BODIES:
                check(r["launches"][name] == 0,
                      f"{tag}: the mma.sync body {name} ran on rank "
                      f"{r['rank']}")
        check(all(math.isfinite(v) for v in got), f"{tag}: losses {got}")
        check(max(errs) <= DP2TP2_LOSS_RTOL,
              f"{tag}: losses {got} are {max(errs):.3g} relative from the "
              f"single rank's {one} (bound {DP2TP2_LOSS_RTOL})")
        step_ms = [h["step_time_s"] * 1e3 for h in r0["history"]]
        ms = sum(step_ms[1:]) / (len(step_ms) - 1)
        seq, batch = len(batches[0]["tokens"][0]), len(batches[0]["tokens"])
        rec = {"model": cfg.name, "layers": cfg.num_layers,
               "dtype": cfg.dtype, "mesh": mesh, "seq": seq, "batch": batch,
               "steps": len(batches), "losses": got, "single_rank": one,
               "max_rel_err": max(errs), "bound": DP2TP2_LOSS_RTOL,
               "step_ms": step_ms, "ms_per_step": ms,
               "tokens_per_s": seq * batch / (ms / 1e3),
               "single_rank_ms_per_step": one_ms,
               "peak_memory_bytes_by_rank": [r["peak_memory_bytes"]
                                             for r in recs],
               "census": r0["expected_census"],
               "launches_by_rank": [{n: r["launches"][n]
                                     for n in TRAIN_KERNELS} for r in recs],
               "card": card, "note": RANKS_NOTE}
        print(f"[{tag}] {cfg.name} {cfg.num_layers} layers bf16, data "
              f"{mesh[0]} x model {mesh[1]}, seq {seq} x batch {batch}, "
              f"{len(batches)} steps: losses {got} within {max(errs):.3g} "
              f"relative of the single rank's {one} (bound "
              f"{DP2TP2_LOSS_RTOL}); {ms:.1f} ms a step over steps 2-"
              f"{len(batches)} (single rank {one_ms:.1f} ms); peak memory by "
              f"rank {[round(r['peak_memory_bytes'] / 2**30, 2) for r in recs]}"
              f" GiB; a step's collectives {r0['expected_census']}; launches "
              f"by rank {rec['launches_by_rank']} [{card}; {RANKS_NOTE}]",
              flush=True)
        record[tag.replace("-", "_")] = rec
    print(f"[train-family] the single-rank runs in {single_s:.1f}s, the "
          f"spawn in {spawn_s:.1f}s", flush=True)
    r0 = out[0][0][len(PARITY_FAMILY)]
    return record, {"train_ep4": {n: r0["launches"].get(n, 0)
                                  for n in read_launches()}}


# ---------------------------------------------------------------------------
# phase 20: the chunked path's levers at hymba-1.5b's full width
# ---------------------------------------------------------------------------

# arch, layers, batch, seq: bf16 forward + backward of each variant
LEVERS = ("hymba-1.5b", 4, 4, 2048)
LEVER_RUNS = (("pallas", {}),
              ("chunked", {}),
              ("chunked+pv_bf16", {"attn_pv_bf16": True}),
              ("chunked+banded+pv_bf16", {"attn_pv_bf16": True,
                                          "banded_window": True}))
LEVERS_BF16_TOL = 2e-2          # chunked against pallas, scaled by the max
LEVERS_FP32_TOL = 1e-4          # banded against chunked, float32, 2 layers


def score_bytes(cfg, b: int, s: int, banded: bool) -> int:
    """float32 score bytes one attention layer of the chunked path forms
    (from the shapes): banded, s * 2W a head (s padded to whole windows);
    chunked, s * s with the keys rounded up to whole chunks."""
    if banded:
        rows = -(-s // cfg.window) * cfg.window
        per_head = rows * 2 * cfg.window
    else:
        per_head = s * (-(-s // cfg.attn_chunk_size) * cfg.attn_chunk_size)
    return b * cfg.num_heads * per_head * 4


def _layer0_errs(g, want) -> dict:
    """Layer 0's gradients against ``want``'s: max |g - want| over the
    largest |want| of all of layer 0's gradients (``layer``), and the
    largest of each leaf's max |g - want| over its own max |want|
    (``leaf``, with its path ``worst``)."""
    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            return [x for k, v in tree.items() for x in flat(v, f"{prefix}/{k}")]
        return [(prefix, tree.float())]

    pairs = [(k, a, w) for (k, a), (_, w) in zip(flat(g["blocks"][0]),
                                                 flat(want["blocks"][0]))]
    top = max(float(w.abs().max()) for _, _, w in pairs)
    leaf = {k: scaled_err(a, w) for k, a, w in pairs}
    worst = max(leaf, key=leaf.get)
    return {"layer": max(float((a - w).abs().max()) for _, a, w in pairs)
            / top, "leaf": leaf[worst], "worst": worst}


def levers_phase(torch, seed: int, card: str) -> tuple[dict, dict]:
    """Phase 20: the chunked path's levers (``attn_chunk_size``,
    ``attn_pv_bf16``, ``banded_window``; plain PyTorch, the reference's
    XLA-level path) at hymba-1.5b's full width (d 1600, 25 q / 5 kv heads
    of 64, window 1024), 4 of its 32 layers, bf16, one batch of 4 x 2048
    tokens without segment ids: one forward + backward each with
    ``attn_impl="pallas"`` (#1-#3), ``"chunked"``, ``"chunked"`` +
    ``attn_pv_bf16`` and ``"chunked"`` + ``banded_window`` +
    ``attn_pv_bf16``, from the same weights. Each chunked run's loss and
    layer-0 gradients held to the pallas run's within ``LEVERS_BF16_TOL``,
    the gradients scaled by the largest of layer 0's (``_layer0_errs``;
    each leaf by its own max is printed beside it, and every bf16 run
    against a float32 chunked run of the same weights: 4 layers of bf16
    backward put each leaf 1-2e-2 from it, pallas's too); ms of a forward
    + backward (CUDA events, after one untimed pass), the peak memory
    above the weights and the attention's score bytes a layer
    (``score_bytes``). Then float32 at 2 layers: banded against chunked,
    loss and layer-0 gradients (each leaf by its own max) within
    ``LEVERS_FP32_TOL``. Launch counters are reset just before each run
    and read just after: the pallas run launches #1-#3, the chunked runs
    nothing. Returns (record, {"levers": the pallas run's launches})."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_map
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    arch, layers, b, s = LEVERS
    dev = torch.device("cuda")
    base = dataclasses.replace(get_config(arch), num_layers=layers)
    batch = dict(SyntheticLM(base.vocab_size, s, b, seed=seed).batch_at(0))
    del batch["segment_ids"]
    params = build_model(base).init(
        torch.Generator(device=dev).manual_seed(seed), device=dev)
    f32 = dataclasses.replace(base, dtype="float32", attn_impl="chunked")
    ref_loss, ref = _grads(torch, build_model(f32),
                           tree_map(lambda t: t.float(), params), batch)
    runs, launches = {}, {}
    for tag, kw in LEVER_RUNS:
        cfg = dataclasses.replace(base, attn_impl=tag.split("+")[0], **kw)
        model = build_model(cfg)
        release(torch)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        loss, grads = _grads(torch, model, params, batch)
        torch.cuda.synchronize()
        got = read_launches()
        for name, n in got.items():
            check((n > 0) == (tag == "pallas" and name in TRAIN_KERNELS),
                  f"levers {tag}: kernel {name} launched {n} times")
        peak = torch.cuda.max_memory_allocated(dev) - held
        ms = time_ms(torch, [lambda: _grads(torch, model, params, batch)],
                     warmup=0, iters=2)
        check(math.isfinite(loss), f"levers {tag}: loss {loss}")
        runs[tag] = {"loss": loss, "ms": ms, "peak_memory_bytes": peak,
                     "score_bytes_per_layer": (
                         None if tag == "pallas" else
                         score_bytes(cfg, b, s, cfg.banded_window)),
                     "vs_float32": dict(_layer0_errs(grads, ref),
                                        loss=abs(loss - ref_loss)
                                        / abs(ref_loss))}
        if tag == "pallas":
            launches, want_loss, want = got, loss, grads
            continue
        errs = dict(_layer0_errs(grads, want),
                    loss=abs(loss - want_loss) / abs(want_loss))
        runs[tag]["vs_pallas"] = errs
        check(max(errs["loss"], errs["layer"]) <= LEVERS_BF16_TOL,
              f"levers {tag}: loss {loss} and layer-0 grads are {errs} from "
              f"the pallas run's (loss {want_loss}; bound {LEVERS_BF16_TOL})")
        del grads
    del params, want, ref
    # float32, 2 layers: the banded layout is exact
    f32 = dataclasses.replace(f32, num_layers=2)
    params = build_model(f32).init(
        torch.Generator(device=dev).manual_seed(seed + 1), device=dev)
    loss_c, g_c = _grads(torch, build_model(f32), params, batch)
    loss_b, g_b = _grads(torch, build_model(dataclasses.replace(
        f32, banded_window=True)), params, batch)
    f32_errs = dict(_layer0_errs(g_b, g_c),
                    loss=abs(loss_b - loss_c) / abs(loss_c))
    check(max(f32_errs["loss"], f32_errs["leaf"]) <= LEVERS_FP32_TOL,
          f"levers float32: banded is {f32_errs} from chunked (loss "
          f"{loss_b} against {loss_c}; bound {LEVERS_FP32_TOL})")
    del params, g_c, g_b

    def errs_text(e):
        return (f"loss {e['loss']:.3g}, layer-0 grads {e['layer']:.3g} of "
                f"the layer's max ({e['leaf']:.3g} of its own at "
                f"{e['worst']})")

    for tag, r in runs.items():
        extra = ("" if tag == "pallas" else
                 f"; against pallas: {errs_text(r['vs_pallas'])} (bound "
                 f"{LEVERS_BF16_TOL}); scores {r['score_bytes_per_layer']} "
                 f"bytes a layer")
        print(f"[levers] {arch} {layers} layers bf16, {b} x {s} tokens, "
              f"{tag}: loss {r['loss']:.6f}; {r['ms']:.2f} ms a forward + "
              f"backward (CUDA events); peak {r['peak_memory_bytes'] / 2**30:.3f}"
              f" GiB above the weights; against float32: "
              f"{errs_text(r['vs_float32'])}{extra} [{card}]", flush=True)
    print(f"[levers] float32, 2 layers: banded against chunked: "
          f"{errs_text(f32_errs)} (bound {LEVERS_FP32_TOL}); pallas launches "
          f"{launches} [{card}]", flush=True)
    return ({"arch": arch, "layers": layers, "batch": b, "seq": s,
             "runs": runs, "float32_banded_vs_chunked": f32_errs,
             "card": card}, {"levers": launches})


# ---------------------------------------------------------------------------
# phase 22: the sequence-sharded decode, ranks sharing one card
# ---------------------------------------------------------------------------

# parity-kvseq's ("data", "model") meshes; serve-kvseq2's traffic: lanes,
# capacity (the reference's decode_32k), prompt, greedy decode steps (each
# lane's writes cross the slice boundary at 16384 in decode step 9), and
# serve-kvseq2-paged's page size (4096 pages, 2048 a rank)
KVSEQ_PARITY_MESHES = ((1, 2), (2, 2))
KVSEQ_SERVE = {"serve_kvseq2": "contiguous", "serve_kvseq2_paged": "paged"}
# the depth of each serve: serve-kvseq2-paged runs 8 of granite's 40 layers
# (cut first to keep the script under 950 s, as ROADMAP's order says), and
# serve-kvseq2 8 too (a slow host took 1197 s, 3 s under the limit)
KVSEQ_LAYERS = {"serve_kvseq2": 8, "serve_kvseq2_paged": 8}
KVSEQ_LANES, KVSEQ_CAPACITY, KVSEQ_PROMPT, KVSEQ_STEPS = 2, 32768, 16376, 16
KVSEQ_PAGE = 16
# the kernels held at serve-kvseq2's rank slices: global lengths mid-decode
# (lane 0 past the slice boundary, lane 1 short of it: rank 1 has nothing
# of lane 1 to attend)
KVSEQ_KV_LEN = (16384 + 8, 16380)


def kvseq_rank(spec: dict) -> list:
    """What one spawned rank of phase 22 runs: ``launch.kv_seq_rank`` with
    TF32 off, as in the parent."""
    import torch

    from repro_torch.distributed import launch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    use_io_model()
    return launch.kv_seq_rank(spec)


def _kvseq_slices(torch, gen, paged: bool):
    """serve-kvseq2's decode operands at a rank's slice, for both ranks of
    model 2: q (2, 32, 1, 64) bf16 and a random cache of 32768 slots (or
    4096 pages of 16 in the interleaved layout) cut in two, with the
    arguments and call of each rank's #7 (or #8) launch as
    ``flash_decode_slice`` (``flash_decode_paged_slice``) makes it."""
    from repro_torch.core import masks as M
    from repro_torch.kernels import tuning
    from repro_torch.models.transformer import interleaved_page_table

    dev = torch.device("cuda")
    b, hq, hkv, d, m = KVSEQ_LANES, 32, 8, 64, 2
    cap = KVSEQ_CAPACITY
    kv_len = torch.tensor(KVSEQ_KV_LEN, dtype=torch.int32, device=dev)
    q = torch.randn((b, hq, 1, d), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    scale = d ** -0.5
    ranks = []
    if not paged:
        cs = cap // m
        bk, splits = tuning.resolve_decode_geometry(
            cs, None, None, head_dim=d, dtype=torch.bfloat16, on_card=True,
            device=dev)
        for r in range(m):
            k = torch.randn((b, hkv, cs, d), generator=gen, device=dev,
                            dtype=torch.bfloat16)
            v = torch.randn_like(k)
            pos = r * cs + torch.arange(cs, device=dev)
            valid = M.element_mask((kv_len - 1)[:, None], pos[None, :],
                                   causal=True)
            local = torch.clamp(kv_len - r * cs, 0, cs)
            lay = M.kv_block_layout(valid, bk)
            ranks.append(((q, k, v, local, lay),
                          dict(scale=scale, block_k=bk, num_splits=splits,
                               window=None, kv_mask=None), valid))
        return ranks
    T = cap // KVSEQ_PAGE
    n = b * T // m
    table = interleaved_page_table(b, T, dev)
    _, splits = tuning.resolve_decode_geometry(
        cap, None, None, head_dim=d, dtype=torch.bfloat16,
        page_size=KVSEQ_PAGE, on_card=True, device=dev)
    for r in range(m):
        kp = torch.randn((hkv, n, KVSEQ_PAGE, d), generator=gen, device=dev,
                         dtype=torch.bfloat16)
        vp = torch.randn_like(kp)
        local = table - r * n
        local = torch.where((local >= 0) & (local < n), local,
                            torch.full_like(local, -1))
        lay = M.paged_block_layout(kv_len, local, KVSEQ_PAGE)
        valid = ((lay != M.BLOCK_SKIP).repeat_interleave(KVSEQ_PAGE, dim=1)
                 & M.decode_kv_valid(kv_len, cap))
        ranks.append(((q, kp, vp, local, kv_len, lay),
                      dict(scale=scale, num_splits=splits, window=None),
                      valid))
    return ranks


def kvseq_kernel_phase(torch, seed: int) -> dict:
    """#7 and #8 at serve-kvseq2's rank slices (``_kvseq_slices``): each
    rank's launch against its plain partials, both ranks' partials merged
    (as ``attention_layer.merge_rank_partials`` merges them) against the
    merged plain ones within the bf16 bound (|o| err <= 2e-2), and rank
    0's launch (its slice full) timed against its plain version, its
    bound over the keys this data puts in its reach and SDPA over the
    same keys. Returns {kernel: {path: entry}} for the kernel records'
    ``at_shapes``."""
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels.ref import gather_pages

    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(seed + 22)
    out = {}
    for name, path, paged in (("flash_decode", "serve_kvseq2", False),
                              ("flash_decode_paged", "serve_kvseq2_paged",
                               True)):
        whole = whole_decode(fd, paged=paged)
        plain_fn = (fd.flash_decode_paged_partials_plain if paged
                    else fd.flash_decode_partials_plain)
        ranks = _kvseq_slices(torch, gen, paged)
        parts, pparts, o_p_errs = [], [], []
        for args, call, _ in ranks:
            o, p = whole(*args, **call)
            torch.cuda.synchronize()
            pp = plain_fn(*args, **call)
            o_p_errs.append(check_partials(f"{name} at {path}", p, pp))
            parts.append(p)
            pparts.append(pp)

        def merged(ps):
            return fd._merge_split_partials(
                *(torch.cat([p[i] for p in ps], dim=2) for i in range(3)),
                torch.bfloat16)

        got, want = merged(parts), merged(pparts)
        merge_err = float((got.float() - want.float()).abs().max())
        check(merge_err <= 2e-2, f"{name} at {path}: the ranks' merged output "
                                 f"{merge_err} from the plain version's")
        args, call, valid = ranks[0]
        q = args[0]
        o, p = whole(*args, **call)
        pp = plain_fn(*args, **call)
        o_plain = fd._merge_split_partials(*pp, q.dtype)
        rows = int(valid.sum())
        kv_src = args[1]
        hkv, d = kv_src.shape[0 if paged else 1], q.shape[-1]
        kv_bytes = 2 * rows * hkv * d * kv_src.element_size()
        sets = copies(torch, gen, args[:3], nbytes(*args[1:3]))
        ms, call_ms = timed(torch, [lambda a=a: whole(*a, *args[3:], **call)
                                    for a in sets])
        plain_ms = device_ms(torch, [lambda: fd._merge_split_partials(
            *plain_fn(*args, **call), q.dtype)], warmup=1, iters=3)
        b_ms, b_by = bound(nbytes(q, o, *p, *args[3:]) + kv_bytes,
                           4.0 * d * rows * q.shape[1], BF16_FLOPS_PER_S)
        mask = valid[:, None, None, :]
        if paged:
            kk = [(a[0], gather_pages(a[1], args[3].clamp_min(0)),
                   gather_pages(a[2], args[3].clamp_min(0))) for a in sets]
        else:
            kk = sets
        lib_ms = device_ms(torch, [lambda a=a: sdpa(
            *a, attn_mask=mask, scale=call["scale"], enable_gqa=True)
            for a in kk])
        del kk
        rec = _kernel_record(
            name, "src/repro_torch/kernels/csrc/flash_decode.cu",
            "src/repro/kernels/flash_decode.py:"
            + ("329" if paged else "169"), (o, p[1], p[2]),
            (o_plain, pp[1], pp[2]), ms, plain_ms, b_ms, b_by, lib_ms,
            call_ms=call_ms,
            shape=(f"rank 0 of model 2: b={q.shape[0]} hq={q.shape[1]} "
                   f"hkv={hkv} d={d} "
                   + (f"pages of {KVSEQ_PAGE}, 2048 of 4096 its own"
                      if paged else "slots [0, 16384) of 32768")
                   + f", global kv_len {list(KVSEQ_KV_LEN)}, splits "
                     f"{call['num_splits']}, {rows} keys in reach"),
            library="SDPA over the rank's keys, bool mask, GQA")
        rec.update(merged_over_ranks_err=merge_err, o_p_errs=o_p_errs)
        out[name] = {path: rec}
        del ranks, sets, parts, pparts
        release(torch)
    return out


def _kvseq_single(torch, model, params, batch, capacity, steps):
    """The single rank's greedy decode on the card: tokens (b, steps + 1)
    and float32 logits (b, steps + 1, V) on the host (prefill first), its
    decode tok/s and its decode state's bytes."""
    with torch.inference_mode():
        state, logits = model.prefill(params, batch, capacity)
        toks, lgs = [logits[:, -1].argmax(-1)], [logits[:, -1].float().cpu()]
        state_bytes = sum(t.numel() * t.element_size()
                          for t in state["caches"]["kv"].values())
        state_bytes += state["kv_len"].numel() * 4
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            state, logits = model.decode_step(params, state,
                                              toks[-1].to(torch.int32))
            toks.append(logits[:, -1].argmax(-1))
            lgs.append(logits[:, -1].float().cpu())
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    return (torch.stack(toks, 1).cpu().numpy(), torch.stack(lgs, 1),
            steps * batch["tokens"].shape[0] / dt, state_bytes)


def kvseq_phase(torch, seed: int, card: str) -> tuple[dict, dict]:
    """Phase 22: the sequence-sharded decode
    (``train.steps.make_sharded_serve_steps``: the KV capacity, or the
    page pool, cut over "model", each rank's #7 / #8 partials merged
    across ranks) as gloo ranks sharing the one card
    (``distributed.launch.kv_seq_rank``), one spawn of 2 ranks and one
    of 4.

    * parity-kvseq: granite-3-2b at full width, 2 layers, float32,
      contiguous and paged at (data 1, model 2) and (data 2, model 2),
      two lanes of a 120-token prompt decoding 12 steps over a capacity
      of 256 (the slice boundary at 128), against the single-rank
      ``Model.decode_step`` on the card: greedy tokens identical, prefill
      and decode logits within 1e-4, the census of every step equal to
      ``expected_kv_seq_decode_census`` on every rank;
    * serve-kvseq2 / serve-kvseq2-paged: granite-3-2b in bf16 at full
      width, ``KVSEQ_LAYERS`` deep (8 layers each), data 1 x model
      2, ``KVSEQ_LANES`` lanes of
      ``KVSEQ_PROMPT``-token prompts at capacity ``KVSEQ_CAPACITY`` (pages
      of ``KVSEQ_PAGE``), ``KVSEQ_STEPS`` decode steps teacher-forced
      along the single rank's greedy tokens: logits within
      ``TP_LOGIT_SPACINGS`` bf16 spacings of the single rank's at the
      row's top |logit|, a rank's argmax parting from the single rank's
      token only at a top-2 margin within twice that; #1, and #7 or #8,
      launched on every rank; decode tok/s, per-rank peak memory and
      decode-state bytes, the latter against ``launch.dryrun``'s per-rank
      estimate.

    Returns ({"parity_kvseq", path: record, "spawn_s"}, {path: rank 0's
    launches})."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.distributed import launch
    from repro_torch.distributed.sharding import auto_rules
    from repro_torch.launch.dryrun import decode_state_bytes
    from repro_torch.models import build_model

    dev = torch.device("cuda")
    rs = __import__("numpy").random.RandomState(seed + 22)
    pcfg = dataclasses.replace(get_config("granite-3-2b"), num_layers=2,
                               dtype="float32", attn_impl="pallas",
                               use_decode_kernel=True)
    pb = {"tokens": rs.randint(1, pcfg.vocab_size, (2, 120)).astype("int32")}
    pcap, psteps = 256, 12
    pmodel = build_model(pcfg)
    pparams = pmodel.init(torch.Generator(device=dev).manual_seed(seed),
                          device=dev)
    want_t, want_l, _, _ = _kvseq_single(
        torch, pmodel, pparams, {k: torch.as_tensor(v, device=dev)
                                 for k, v in pb.items()}, pcap, psteps)
    del pparams
    release(torch)

    sb = {"tokens": rs.randint(1, get_config("granite-3-2b").vocab_size,
                               (KVSEQ_LANES, KVSEQ_PROMPT)).astype("int32")}
    # the single rank's greedy decode at each serve's depth (once a depth)
    cfgs, refs, by_depth = {}, {}, {}
    for path, layers in KVSEQ_LAYERS.items():
        cfg = dataclasses.replace(get_config("granite-3-2b"),
                                  num_layers=layers, attn_impl="pallas",
                                  use_decode_kernel=True)
        cfgs[path] = cfg
        if layers in by_depth:
            refs[path] = by_depth[layers]
            continue
        model = build_model(cfg)
        params = model.init(torch.Generator(device=dev).manual_seed(seed),
                            device=dev)
        refs[path] = _kvseq_single(
            torch, model, params, {k: torch.as_tensor(v, device=dev)
                                   for k, v in sb.items()}, KVSEQ_CAPACITY,
            KVSEQ_STEPS)
        by_depth[layers] = refs[path]
        del params
        release(torch)
        print(f"[serve-kvseq1] granite-3-2b {layers} layers bf16, one "
              f"process: {KVSEQ_LANES} lanes x {KVSEQ_STEPS} decode steps at "
              f"{KVSEQ_PROMPT}-token prompts, capacity {KVSEQ_CAPACITY}: "
              f"{refs[path][2]:.1f} decode tok/s, decode state "
              f"{refs[path][3]} bytes [{card}]", flush=True)

    def prun(mesh, state):
        return {"cfg": pcfg, "shape": mesh, "state": state, "rules": "auto",
                "batch": pb, "capacity": pcap, "steps": psteps,
                "page_size": 16}

    def srun(path, state):
        return {"cfg": cfgs[path], "shape": (1, 2), "state": state,
                "rules": "auto", "batch": sb, "capacity": KVSEQ_CAPACITY,
                "steps": KVSEQ_STEPS, "page_size": KVSEQ_PAGE,
                "forced": [refs[path][0][:, i] for i in range(KVSEQ_STEPS)]}

    jobs = {2: [("parity", (1, 2), s) for s in ("contiguous", "paged")]
            + [(p, (1, 2), s) for p, s in KVSEQ_SERVE.items()],
            4: [("parity", (2, 2), s) for s in ("contiguous", "paged")]}
    results = {}
    t0 = time.perf_counter()
    for world, mine in jobs.items():
        runs = [prun(mesh, s) if name == "parity" else srun(name, s)
                for name, mesh, s in mine]
        recs = launch.spawn(world, kvseq_rank, {
            "seed": seed, "params": None, "device": "cuda",
            "backend": "gloo", "runs": runs}, threads=2)
        for k, key in enumerate(mine):
            results[key] = [r[k] for r in recs]
    spawn_s = time.perf_counter() - t0

    parity = []
    for mesh in KVSEQ_PARITY_MESHES:
        for state in ("contiguous", "paged"):
            recs = results[("parity", mesh, state)]
            tag = f"parity-kvseq data={mesh[0]} model={mesh[1]} {state}"
            err = 0.0
            for r in recs:
                lo, hi = r["lanes"]
                check((r["tokens"] == want_t[lo:hi]).all(),
                      f"{tag}: rank {r['rank']}'s greedy tokens differ from "
                      f"the single rank's")
                err = max(err, float(abs(r["logits"]
                                         - want_l[lo:hi].numpy()).max()))
                for c in r["census"]:
                    check(c == r["expected_census"],
                          f"{tag}: rank {r['rank']}'s census {c} is not "
                          f"{r['expected_census']}")
            check(err <= 1e-4, f"{tag}: logits {err} from the single rank's")
            print(f"[{tag}] granite-3-2b 2 layers float32: greedy tokens "
                  f"identical to the single rank's over {psteps} steps, max "
                  f"|logit - single| {err:.3g}, census "
                  f"{recs[0]['expected_census']} every step on every rank "
                  f"[{card}; {RANKS_NOTE}]", flush=True)
            parity.append({"data": mesh[0], "model": mesh[1], "state": state,
                           "identical": True, "max_abs_logit_err": err,
                           "census": recs[0]["expected_census"]})

    out, launches = {"parity_kvseq": parity, "spawn_s": spawn_s}, {}
    axes = {"data": 1, "model": 2}
    for path, state in KVSEQ_SERVE.items():
        tag = path.replace("_", "-")
        recs = results[(path, (1, 2), state)]
        cfg = cfgs[path]
        ref_t, ref_l, ref_tps, ref_bytes = refs[path]
        est = decode_state_bytes(
            cfg, axes, auto_rules(cfg, axes),
            ShapeConfig(path, KVSEQ_CAPACITY, KVSEQ_LANES, "decode"),
            page_size=KVSEQ_PAGE if state == "paged" else None)
        kernel = "flash_decode_paged" if state == "paged" else "flash_decode"
        diffs, divergences = [], []
        for r in recs:
            check(r["state_bytes"] == est,
                  f"{tag}: rank {r['rank']}'s decode state holds "
                  f"{r['state_bytes']} bytes, the dry-run estimates {est}")
            for name in ("flash_fwd_sm90", kernel):
                check(r["launches"][name] > 0,
                      f"{tag}: kernel {name} never launched on rank "
                      f"{r['rank']}")
            for c in r["census"]:
                check(c == r["expected_census"],
                      f"{tag}: rank {r['rank']}'s census {c} is not "
                      f"{r['expected_census']}")
            got = torch.from_numpy(r["logits"])
            for i in range(KVSEQ_LANES):
                for j in range(KVSEQ_STEPS + 1):
                    row = ref_l[i, j]
                    top = float(row.abs().max())
                    diffs.append(float((got[i, j] - row).abs().max())
                                 / _spacing(top))
                    mine = int(r["tokens"][i, j])
                    if mine != int(ref_t[i, j]):
                        margin = float(row[int(ref_t[i, j])] - row[mine])
                        spc = margin / _spacing(top)
                        divergences.append({"rank": r["rank"], "lane": i,
                                            "step": j, "spacings": spc})
                        check(spc <= 2 * TP_LOGIT_SPACINGS,
                              f"{tag}: lane {i} parts from the single rank "
                              f"at step {j} with a top-2 margin of {spc:.3g} "
                              f"bf16 spacings")
        check(max(diffs) <= TP_LOGIT_SPACINGS,
              f"{tag}: teacher-forced logits {max(diffs):.3g} bf16 spacings "
              f"from the single rank's (limit {TP_LOGIT_SPACINGS})")
        r0 = recs[0]
        n_tok = KVSEQ_LANES * KVSEQ_STEPS
        rec = {"model": cfg.name, "layers": cfg.num_layers, "dtype": cfg.dtype,
               "data": 1, "model_ranks": 2, "state": state,
               "lanes": KVSEQ_LANES, "capacity": KVSEQ_CAPACITY,
               "prompt": KVSEQ_PROMPT, "decode_steps": KVSEQ_STEPS,
               "page_size": KVSEQ_PAGE if state == "paged" else None,
               "prefill_s_by_rank": [r["prefill_s"] for r in recs],
               "decode_s_by_rank": [r["decode_s"] for r in recs],
               "decode_tokens_per_s": n_tok / max(r["decode_s"]
                                                  for r in recs),
               "single_rank_decode_tokens_per_s": ref_tps,
               "single_rank_state_bytes": ref_bytes,
               "peak_memory_bytes_by_rank": [r["peak_memory_bytes"]
                                             for r in recs],
               "state_bytes_by_rank": [r["state_bytes"] for r in recs],
               "dryrun_state_bytes": est,
               "census": r0["expected_census"],
               "launches_by_rank": [{n: r["launches"][n] for n in
                                     ("flash_fwd_sm90", kernel)} for r in recs],
               "max_forced_logit_spacings": max(diffs),
               "divergences": divergences, "card": card, "note": RANKS_NOTE}
        out[path] = rec
        launches[path] = r0["launches"]
        print(f"[{tag}] granite-3-2b {cfg.num_layers} layers bf16, data 1 x "
              f"model 2, "
              f"{state}: {n_tok} decode tokens at "
              f"{rec['decode_tokens_per_s']:.1f} tok/s (single rank "
              f"{ref_tps:.1f}), prefill {max(rec['prefill_s_by_rank']):.1f}s,"
              f" peak memory by rank "
              f"{[round(r['peak_memory_bytes'] / 2**30, 2) for r in recs]} GiB,"
              f" decode state {rec['state_bytes_by_rank']} bytes by rank "
              f"(dry-run {est}; single rank {ref_bytes}), census "
              f"{rec['census']} a step; teacher-forced logits within "
              f"{max(diffs):.3g} bf16 spacings (limit {TP_LOGIT_SPACINGS}), "
              f"{len(divergences)} argmax partings at "
              f"{[round(d['spacings'], 2) for d in divergences]} spacings; "
              f"launches by rank {rec['launches_by_rank']} "
              f"[{card}; {RANKS_NOTE}]", flush=True)
    print(f"[kvseq] the spawns in {spawn_s:.1f}s", flush=True)
    return out, launches


# ---------------------------------------------------------------------------
# phase 21: the tuner, autotuning on the card
# ---------------------------------------------------------------------------

# the autotuned shapes: (tag, arch, heads divided by, head_dim taken from
# the arch, shards, backward); every one at a bucket of 2048 rows, causal
TUNING_TILES = (("granite-fwd", "granite-3-2b", 1, 1, False),
                ("granite-bwd", "granite-3-2b", 1, 1, True),
                ("dp2tp2-bwd", "granite-3-2b", 2, 2, True),
                ("olmo-fwd", "olmo-1b", 1, 1, False))
TUNING_SEQ = 2048
TUNING_DECODE = ((None, 2048), (16, 2048))   # (page_size, capacity)
TUNING_SP = (256, 2048, 2)                   # chunk, prefix, sp


def _new_entry(path: pathlib.Path, before: set, resolve):
    """Run ``resolve`` and return (its result, the one cache entry it
    added under its key)."""
    out = resolve()
    entries = json.loads(path.read_text())["entries"]
    (key,) = set(entries) - before
    return out, key, entries[key]


def _tile_winner_errs(torch, gen, hq, hkv, d, bq, bk, backward) -> dict:
    """The forward kernel at the winning tiles against its plain version
    (and, for a backward winner, the dq / dkv kernels from the kernel
    forward's residuals against the plain backward), at the timed shape
    (1, hq, TUNING_SEQ, d), causal, bf16."""
    from repro_torch.core import masks as M
    from repro_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    S = TUNING_SEQ

    def randn(*shp):
        return torch.randn(*shp, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    q, k, v, do = randn(1, hq, S, d), randn(1, hkv, S, d), \
        randn(1, hkv, S, d), randn(1, hq, S, d)
    layout = M.compile_block_layout(M.MaskSpec(causal=True), S, S, bq,
                                    bk).as_array(dev)
    call = dict(scale=d ** -0.5, causal=True, window=None, q_offset=0,
                block_q=bq, block_k=bk)
    o, m, l = fa.flash_attention_forward(q, k, v, None, layout, **call)
    po = plain_by_heads(torch, fa.flash_attention_forward_plain, (q, k, v),
                        (None, layout), call)[0]
    errs = {"o": float((o.float() - po.float()).abs().max())}
    check(errs["o"] <= 2e-2, f"tuning: flash_fwd at {bq}x{bk} d {d}: max "
                             f"|o - plain| {errs['o']}")
    if backward:
        res = (q, k, v, o, do, m, l, None, layout)
        got = fa.flash_attention_backward(*res, **call)
        want = plain_by_heads(torch, fa.flash_attention_backward_plain,
                              res[:7], res[7:], call)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            errs[name] = scaled_err(g, w)
            check(errs[name] <= 2e-2, f"tuning: flash_bwd at {bq}x{bk} d "
                                      f"{d}: {name} scaled error "
                                      f"{errs[name]}")
    return errs


def _decode_winner_err(torch, gen, d, blk, splits, page_size, cap) -> float:
    """The whole decode at the winning geometry against the plain partials
    and torch merge: 2 sequences of 8 q / 2 kv heads, kv_len 2048 and
    1500, bf16."""
    from repro_torch.core import masks as M
    from repro_torch.kernels import flash_decode as fd

    dev = torch.device("cuda")
    q = torch.randn(2, 8, 1, d, generator=gen, device=dev,
                    dtype=torch.bfloat16)
    kv_len = torch.tensor([cap, 1500], dtype=torch.int32, device=dev)
    if page_size is None:
        kc, vc = (torch.randn(2, 2, cap, d, generator=gen, device=dev,
                              dtype=torch.bfloat16) for _ in range(2))
        lay = M.kv_block_layout(M.decode_kv_valid(kv_len, cap), blk)
        call = dict(scale=d ** -0.5, block_k=blk, num_splits=splits,
                    window=None)
        args = (q, kc, vc, kv_len, lay)
        plain = fd.flash_decode_partials_plain
    else:
        pages = cap // page_size
        kc, vc = (torch.randn(2, 2 * pages, page_size, d, generator=gen,
                              device=dev, dtype=torch.bfloat16)
                  for _ in range(2))
        table = torch.randperm(2 * pages, generator=gen, device=dev).to(
            torch.int32).reshape(2, pages)
        lay = M.paged_block_layout(kv_len, table, page_size)
        call = dict(scale=d ** -0.5, num_splits=splits, window=None)
        args = (q, kc, vc, table, kv_len, lay)
        plain = fd.flash_decode_paged_partials_plain
    o, _ = whole_decode(fd, paged=page_size is not None)(*args, **call)
    want = fd._merge_split_partials(*plain(*args, **call), q.dtype)
    err = float((o.float() - want.float()).abs().max())
    check(err <= 2e-2, f"tuning: decode at block {blk} splits {splits}: "
                       f"max |o - plain| {err}")
    return err


def tuning_phase(torch, seed: int, card: str) -> dict:
    """Phase 21: the tuner on the card (``kernels/tuning.py``), with
    autotuning on and a fresh cache under build/: the attention tiles at
    ``TUNING_TILES`` (forward, or forward + backward under ``|bwd``), the
    contiguous decode at 2048 slots and the paged decode at page 16 over
    2048, then the sp strategy at sp 2. Each first resolution times its
    candidates (the kernels at each tile, layouts compiled outside the
    clock, CUDA events around back-to-back calls queued behind a sleep;
    every candidate's ms and spread, the winner and its source printed); granite's forward is tuned again into a second fresh cache
    and that winner printed; each second resolution must come from the
    cache; each winner
    is held against its plain version (bf16 bounds: |o| 2e-2, gradients
    2e-2 of their max); the calibration of the IO model's bytes against
    the clock is printed beside 3.35 TB/s. Then the ``--smoke`` CLI runs
    twice in a subprocess, the second time with ``--expect-hit``. Autotuning
    is off again after the phase, whatever happens in it."""
    import subprocess

    from repro_torch.configs import get_config
    from repro_torch.kernels import tuning

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 21)
    path = ROOT / "build" / "autotune.json"
    path.unlink(missing_ok=True)
    saved = dict(tuning._STATE)
    tuning.configure_tuning(autotune=True, cache_path=str(path))
    rec = {"card": card, "tiles": {}, "decode": {}}
    try:
        before = set()
        for tag, arch, div, shards, backward in TUNING_TILES:
            cfg = get_config(arch)
            hq, hkv, d = (cfg.num_heads // div, cfg.num_kv_heads // div,
                          cfg.head_dim)
            kw = dict(dtype=torch.bfloat16, mask_class="causal",
                      backward=backward, heads_q=hq, heads_kv=hkv,
                      shards=shards, device=dev)
            first, key, entry = _new_entry(path, before, lambda: tuning.
                                           autotune_tiles(TUNING_SEQ,
                                                          TUNING_SEQ, d, **kw))
            before.add(key)
            again = tuning.autotune_tiles(TUNING_SEQ, TUNING_SEQ, d, **kw)
            check(first.source == "autotuned" and again.source == "cache"
                  and (again.block_q, again.block_k)
                  == (first.block_q, first.block_k),
                  f"tuning {tag}: first {first.source}, second "
                  f"{again.source}")
            ms = {c: us / 1e3 for c, us in entry["candidates_us"].items()}
            spread = {c: us / 1e3 for c, us in entry["spread_us"].items()}
            errs = _tile_winner_errs(torch, gen, hq, hkv, d, first.block_q,
                                     first.block_k, backward)
            print(f"[tuning] {tag} (1, {hq}/{hkv}, {TUNING_SEQ}, {d}) "
                  f"causal{' fwd+bwd' if backward else ''} shards {shards}: "
                  f"candidates ms {ms} (spread ms {spread}); winner "
                  f"{first.block_q}x{first.block_k} ({first.source}, then "
                  f"{again.source}); against plain {errs}", flush=True)
            rec["tiles"][tag] = {"key": key, "candidates_ms": ms,
                                 "spread_ms": spread,
                                 "winner": [first.block_q, first.block_k],
                                 "model_hbm_bytes": entry["model_hbm_bytes"],
                                 "errs": errs}
            if tag == "granite-fwd":
                # the same shape tuned again into a second fresh cache: the
                # winner a later run would persist (printed, not held: a
                # flip means the clock still cannot tell the tiles apart)
                fresh = ROOT / "build" / "autotune_again.json"
                fresh.unlink(missing_ok=True)
                tuning.configure_tuning(cache_path=str(fresh))
                twice = tuning.autotune_tiles(TUNING_SEQ, TUNING_SEQ, d, **kw)
                tuning.configure_tuning(cache_path=str(path))
                rec["tiles"][tag]["fresh_winner"] = [twice.block_q,
                                                     twice.block_k]
                print(f"[tuning] {tag} in a second fresh cache: winner "
                      f"{twice.block_q}x{twice.block_k}", flush=True)
        for page_size, cap in TUNING_DECODE:
            tag = "contig" if page_size is None else f"paged{page_size}"
            d = get_config("granite-3-2b").head_dim
            kw = dict(dtype=torch.bfloat16, page_size=page_size, device=dev)
            first, key, entry = _new_entry(
                path, before,
                lambda: tuning.autotune_decode_geometry(cap, d, **kw))
            before.add(key)
            again = tuning.autotune_decode_geometry(cap, d, **kw)
            check(first.source == "autotuned" and again.source == "cache",
                  f"tuning decode {tag}: first {first.source}, second "
                  f"{again.source}")
            splits = [int(c.split("x")[1]) for c in entry["candidates_us"]]
            check(max(splits) <= tuning.MAX_DECODE_SPLITS,
                  f"tuning decode {tag}: timed {max(splits)} splits")
            ms = {c: us / 1e3 for c, us in entry["candidates_us"].items()}
            spread = {c: us / 1e3 for c, us in entry["spread_us"].items()}
            err = _decode_winner_err(torch, gen, d, first.decode_block_k,
                                     first.num_decode_splits, page_size, cap)
            print(f"[tuning] decode {tag} over {cap}, d {d}: candidates ms "
                  f"{ms} (spread ms {spread}); winner block "
                  f"{first.decode_block_k} splits "
                  f"{first.num_decode_splits} ({first.source}, then "
                  f"{again.source}); max |o - plain| {err:.3g}", flush=True)
            rec["decode"][tag] = {"key": key, "candidates_ms": ms,
                                  "spread_ms": spread,
                                  "winner": [first.decode_block_k,
                                             first.num_decode_splits],
                                  "err": err}
        cfg = get_config("granite-3-2b")
        chunk, prefix, sp = TUNING_SP
        kw = dict(heads_q=cfg.num_heads, heads_kv=cfg.num_kv_heads, sp=sp,
                  dtype=cfg.dtype, layers=cfg.num_layers, device=dev)
        res = tuning.resolve_sp_strategy(chunk, prefix, cfg.head_dim, **kw)
        again = tuning.resolve_sp_strategy(chunk, prefix, cfg.head_dim, **kw)
        check(again["source"] == "cache"
              and again["strategy"] == res["strategy"],
              f"tuning sp: second resolution {again['source']}")
        print(f"[tuning] sp {sp} chunk {chunk} prefix {prefix}: strategy "
              f"{res['strategy']} at slab tile {res['tiles'].block_q} "
              f"({res['source']}, then {again['source']})", flush=True)
        rec["sp"] = {"strategy": res["strategy"],
                     "block_q": res["tiles"].block_q}
        kind = torch.cuda.get_device_name(0).replace("|", "_")
        cal = tuning.autotune_cache().calibration(kind)
        check(cal is not None, "tuning: no calibration sample")
        print(f"[tuning] calibration[{kind}]: io_model-implied "
              f"{cal['model_bytes_per_s'] / 1e9:.2f} GB/s over "
              f"{cal['samples']} timed samples = {cal['vs_nominal']:.4f}x "
              f"nominal ({tuning.nominal_hbm_bw(kind) / 1e9:.0f} GB/s); "
              f"{card}", flush=True)
        rec["calibration"] = cal
    finally:
        tuning._STATE.update(saved)
        tuning.configure_tuning(cache_path=saved["cache_path"])
    smoke = ROOT / "build" / "autotune_smoke.json"
    smoke.unlink(missing_ok=True)
    cmd = [sys.executable, "-m", "repro_torch.kernels.tuning", "--smoke",
           "--device", "cuda", "--cache", str(smoke)]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    rec["cli"] = []
    for extra in ([], ["--expect-hit"]):
        out = subprocess.run(cmd + extra, env=env, capture_output=True,
                             text=True, timeout=300)
        print(f"[tuning] cli{' --expect-hit' if extra else ''} exit "
              f"{out.returncode}:\n{out.stdout.strip()}", flush=True)
        check(out.returncode == 0, f"tuning cli {extra}: exit "
                                   f"{out.returncode}: {out.stderr[-2000:]}")
        rec["cli"].append(out.stdout)
    return rec


# ---------------------------------------------------------------------------
# --ab: parent against change on the serving and training kernels, one call
# ---------------------------------------------------------------------------

_AB_RUN = """
import json, sys
sys.path[:0] = [{src!r}, {here!r}]
import torch
import chip_smoke as cs
cs.HBM_BYTES_PER_S, cs.BF16_FLOPS_PER_S, cs.FP32_FLOPS_PER_S = {rates!r}
from repro_torch.kernels import build
build.build_all()
bwd, fwd = cs.train_kernel_phase(torch, {seed})
kernels = cs.kernel_phase(torch, {seed})
paged_grad = cs.paged_grad_ab(torch, {seed})
cs.profile_serve = lambda *a, **k: {{}}
cs.profile_train = lambda *a, **k: {{}}
serve, _ = cs.serve_phase(torch, {seed}, cs.card_line())
torch.cuda.empty_cache()
dense, _ = cs.dense_serve_phase(torch, {seed}, cs.card_line())
torch.cuda.empty_cache()
train, _ = cs.train_phase(torch, {seed}, cs.card_line())
print("AB " + json.dumps({{
    "kernels": {{r["name"]: r["ms"] for r in kernels + bwd}},
    "bound_ms": {{r["name"]: r["bound_ms"] for r in kernels + bwd}},
    "bwd_dropout_ms": {{r["name"]: r["dropout_ms"] for r in bwd}},
    "bwd_pair_device_ms": fwd["bwd_pair_device_ms"],
    "bwd_ms": fwd["bwd_ms"],
    "call_ms": {{r["name"]: r["call_ms"] for r in kernels}},
    "flash_fwd_train_shape_ms": fwd["ms"],
    "flash_fwd_train_shape_call_ms": fwd["call_ms"],
    "paged_grad": paged_grad,
    "serve": {{n: serve[n] for n in ("tokens_per_s", "ttft_p50_s",
                                     "tok_latency_p50_s", "wall_s")}},
    "dense_serve": {{n: dense[n] for n in ("tokens_per_s", "ttft_p50_s",
                                           "tok_latency_p50_s")}},
    "train": {{n: train[n] for n in ("ms_per_step", "tokens_per_s",
                                     "losses")}}}}))
"""

_PTXAS_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")
_PTXAS_STACK = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores")
_PTXAS_SMEM = re.compile(r"(\d+) bytes smem")


def _cubin(root: pathlib.Path, name: str, out: pathlib.Path):
    """nvcc of one kernel source to a cubin with ``-Xptxas -v`` (the build's
    own flags, without the shared-library ones); returns the process."""
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]
    src = root / "src" / "repro_torch" / "kernels" / "csrc" / f"{name}.cu"
    nvcc = pathlib.Path("/usr/local/cuda/bin/nvcc")
    cmd = [str(nvcc) if nvcc.exists() else "nvcc", *flags, "-cubin",
           "-Xptxas", "-v", "-o", str(out), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _demangle(names: list[str]) -> dict[str, str]:
    tool = pathlib.Path("/usr/local/cuda/bin/cu++filt")
    out = subprocess.run([str(tool) if tool.exists() else "c++filt"],
                         input="\n".join(names), capture_output=True,
                         text=True, timeout=60)
    return dict(zip(names, out.stdout.splitlines()))


def _sass(binary: pathlib.Path) -> dict[str, list[str]]:
    """The SASS instruction text of every kernel (mangled name) in a cubin
    or a built library, from ``cuobjdump -sass`` (addresses and encodings
    dropped)."""
    tool = pathlib.Path("/usr/local/cuda/bin/cuobjdump")
    out = subprocess.run([str(tool) if tool.exists() else "cuobjdump",
                          "-sass", str(binary)], capture_output=True,
                         text=True, timeout=300)
    check(out.returncode == 0,
          f"cuobjdump -sass {binary.name} failed: {out.stderr[-1000:]}")
    body, cur = {}, None
    for line in out.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1)
            body[cur] = []
        elif cur and "/*" in line:
            text = re.sub(r"/\*[^*]*\*/", "", line).strip().rstrip(";").strip()
            if text:
                body[cur].append(text)
    return body


_FWD_BF16 = re.compile(r"flash_fwd_kernel(?:_min)?<__nv_bfloat16, \(int\)(\d+), "
                       r"\(bool\)(\d), \(bool\)(\d), \(bool\)(\d)>")


def fwd_build_counts(proc, cubin: pathlib.Path) -> dict[str, dict]:
    """Registers, spills and [HMMA, all] SASS instructions of every bf16
    ``flash_fwd_kernel`` instantiation (each head dim: paged fa2 and
    "paper", contiguous with and without dropout in both variants), from
    a ``-Xptxas -v`` compile of ``flash_fwd.cu`` to a cubin (started beside
    the build by ``_cubin``, with the build's flags): each must have
    tensor-core (``HMMA``) instructions (no bf16 forward runs the scalar
    body) and none may spill."""
    from repro_torch.kernels.tuning import KERNEL_HEAD_DIMS
    log, _ = proc.communicate()
    check(proc.returncode == 0, f"nvcc -Xptxas -v flash_fwd.cu failed:\n"
                                f"{log[-3000:]}")
    counts = {}
    for kern, info in _kernel_info(log, cubin).items():
        m = _FWD_BF16.search(kern)
        if m:
            d, paged, drop, paper = m.groups()
            key = (f"d{d} {'paged' if paged == '1' else 'contiguous'}"
                   f"{' dropout' if drop == '1' else ''}"
                   f"{' paper' if paper == '1' else ''}")
            counts[key] = {
                "hmma": sum(bool(re.match(r"(@!?U?P\w+ )?HMMA\.", i))
                            for i in info["sass"]),
                "instructions": len(info["sass"]),
                "registers": info.get("registers"), "spill": info.get("spill")}
    print(f"[build] bf16 flash_fwd kernels (HMMA, SASS instructions, "
          f"registers, spill bytes): {json.dumps(counts)}", flush=True)
    # per head dim: paged x 2 variants, contiguous x 2 variants x dropout
    check(len(counts) == 6 * len(KERNEL_HEAD_DIMS),
          f"the built forward lacks a bf16 kernel: {sorted(counts)}")
    check(all(c["hmma"] > 0 for c in counts.values()),
          f"a bf16 flash_fwd_kernel has no HMMA (scalar body): {counts}")
    check(all(c["spill"] == 0 for c in counts.values()),
          f"a bf16 flash_fwd_kernel spills: {counts}")
    return counts


_BWD_BF16 = re.compile(r"flash_bwd_(dq|dkv)_kernel<__nv_bfloat16, "
                       r"\(int\)(\d+), \(bool\)(\d), \(bool\)(\d)>")


def bwd_build_counts(proc, cubin: pathlib.Path) -> dict[str, dict]:
    """Registers, spills and [HMMA, all] SASS instructions of every bf16
    ``flash_bwd_dq_kernel`` / ``flash_bwd_dkv_kernel`` instantiation (paged;
    contiguous, with and without dropout), from a ``-Xptxas -v`` compile
    of ``flash_bwd.cu`` to a cubin (started beside the build by
    ``_cubin``): each must have tensor-core (``HMMA``) instructions (no
    bf16 backward runs the scalar body) and none may spill."""
    from repro_torch.kernels.tuning import KERNEL_HEAD_DIMS
    log, _ = proc.communicate()
    check(proc.returncode == 0, f"nvcc -Xptxas -v flash_bwd.cu failed:\n"
                                f"{log[-3000:]}")
    counts = {}
    for kern, info in _kernel_info(log, cubin).items():
        m = _BWD_BF16.search(kern)
        if m:
            kind, d, paged, drop = m.groups()
            key = (f"{kind} d{d} {'paged' if paged == '1' else 'contiguous'}"
                   f"{' dropout' if drop == '1' else ''}")
            counts[key] = {
                "hmma": sum(bool(re.match(r"(@!?U?P\w+ )?HMMA\.", i))
                            for i in info["sass"]),
                "instructions": len(info["sass"]),
                "registers": info.get("registers"), "spill": info.get("spill")}
    print(f"[build] bf16 flash_bwd kernels (HMMA, SASS instructions, "
          f"registers, spill bytes): {json.dumps(counts)}", flush=True)
    # 2 kernels x each head dim x (paged, contiguous, contiguous dropout)
    check(len(counts) == 2 * 3 * len(KERNEL_HEAD_DIMS),
          f"the built backward lacks a bf16 kernel: {sorted(counts)}")
    check(all(c["hmma"] > 0 for c in counts.values()),
          f"a bf16 flash_bwd kernel has no HMMA (scalar body): {counts}")
    check(all(c["spill"] == 0 for c in counts.values()),
          f"a bf16 flash_bwd kernel spills: {counts}")
    return counts


_DECODE = re.compile(r"flash_decode_kernel(?:_min)?<(float|__nv_bfloat16), "
                     r"\(int\)(\d+), "
                     r"\(bool\)(\d)>")


def decode_build_counts(torch, proc, cubin: pathlib.Path) -> dict[str, dict]:
    """Registers, static shared memory, spills and HMMA instructions of
    every ``flash_decode_kernel`` instantiation (fp32 and bf16, paged and
    contiguous, head dims 16-128) from a ``-Xptxas -v`` compile of
    ``flash_decode.cu`` to a cubin (started beside the build by
    ``_cubin``), with the dynamic shared memory and ring stages its
    launcher gives each (``flash_decode.smem_bytes``); none may spill,
    and every bf16 one must have HMMA (its tensor-core body)."""
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels.tuning import KERNEL_HEAD_DIMS
    log, _ = proc.communicate()
    check(proc.returncode == 0, f"nvcc -Xptxas -v flash_decode.cu failed:\n"
                                f"{log[-3000:]}")
    counts = {}
    for kern, info in _kernel_info(log, cubin).items():
        m = _DECODE.search(kern)
        if m:
            t, d, paged = m.groups()
            bf16 = t == "__nv_bfloat16"
            dyn, stages = fd.smem_bytes(torch.bfloat16 if bf16 else torch.float32,
                                        int(d))
            key = (f"{'bf16' if bf16 else 'fp32'} d{d} "
                   f"{'paged' if paged == '1' else 'contiguous'}")
            counts[key] = {"registers": info.get("registers"),
                           "spill": info.get("spill"),
                           "static_smem": info.get("smem"),
                           "dynamic_smem": dyn, "stages": stages,
                           "hmma": sum(bool(re.match(r"(@!?U?P\w+ )?HMMA\.", i))
                                       for i in info["sass"])}
    print(f"[build] flash_decode_kernel instantiations (registers, spill "
          f"bytes, static and dynamic shared memory, ring stages, HMMA): "
          f"{json.dumps(counts)}", flush=True)
    # 2 dtypes x each head dim x (paged, contiguous)
    check(len(counts) == 2 * 2 * len(KERNEL_HEAD_DIMS),
          f"the built decode lacks an instantiation: {sorted(counts)}")
    check(all(c["spill"] == 0 for c in counts.values()),
          f"a flash_decode_kernel spills: {counts}")
    check(all(c["hmma"] > 0 for k, c in counts.items() if k.startswith("bf16")),
          f"a bf16 flash_decode_kernel has no HMMA (CUDA-core body): {counts}")
    return counts


_BWD_SM90 = re.compile(r"flash_bwd_(dq|dkv)_sm90_kernel<\(int\)(\d+), \(bool\)(\d), "
                       r"\(bool\)(\d)>")
_FWD_SM90 = re.compile(r"flash_fwd_sm90_kernel<\(int\)(\d+), \(bool\)(\d), "
                       r"\(bool\)(\d), \(bool\)(\d)>")
# ptxas's notes that it serialized a kernel's wgmma: for registers (C7512),
# for a wgmma under a branch it cannot prove warpgroup-uniform (C7520)
_PTXAS_SERIAL = re.compile(r"C75(?:12|20).*function '([^']+)'")


def _sm90_key(source: str, kern: str) -> str | None:
    """An sm90 instantiation's short name: ``dq d64 dropout``,
    ``dkv d128 paged``, ``fwd d96 paged paper``; None for another kernel."""
    if source == "flash_bwd_sm90":
        m = _BWD_SM90.search(kern)
        if m:
            kind, d, paged, drop = m.groups()
            return (f"{kind} d{d}{' paged' if paged == '1' else ''}"
                    f"{' dropout' if drop == '1' else ''}")
        return None
    m = _FWD_SM90.search(kern)
    if m:
        d, paged, drop, paper = m.groups()
        return (f"fwd d{d} {'paged' if paged == '1' else 'contiguous'}"
                f"{' dropout' if drop == '1' else ''}"
                f"{' paper' if paper == '1' else ''}")
    return None


# instantiations of each sm90 source: dq / dkv x d 64, 96, 128 x (paged,
# contiguous, contiguous with dropout); d 64, 96, 128 x (paged,
# contiguous, contiguous with dropout) x variant
SM90_KERNELS = {"flash_bwd_sm90": 2 * 3 * 3, "flash_fwd_sm90": 3 * 3 * 2}


def sm90_build_counts(proc, cubin: pathlib.Path,
                      source: str = "flash_bwd_sm90") -> dict[str, dict]:
    """Registers, spills and SASS counts of every instantiation of an sm90
    source (``SM90_KERNELS``: ``flash_bwd_dq_sm90_kernel`` /
    ``flash_bwd_dkv_sm90_kernel`` at d 64, 96, 128, paged and contiguous
    with and without dropout; ``flash_fwd_sm90_kernel`` at d 64, 96, 128, paged and
    contiguous with and without dropout, both variants), from a ``-Xptxas
    -v`` compile of ``<source>.cu`` to a cubin (started beside the build by
    ``_cubin``): each must have wgmma (``HGMMA``) and TMA tile loads
    (``UTMALDG``), and none may spill. ptxas's notes that it serialized a
    kernel's wgmma (C7512, C7520) are recorded, not refused."""
    log, _ = proc.communicate()
    check(proc.returncode == 0, f"nvcc -Xptxas -v {source}.cu failed:\n"
                                f"{log[-3000:]}")
    serial = set(_demangle(sorted(set(_PTXAS_SERIAL.findall(log)))).values())
    counts = {}
    for kern, info in _kernel_info(log, cubin).items():
        key = _sm90_key(source, kern)
        if key:
            ops = [re.sub(r"^@!?U?P\w+ ", "", i).split(" ")[0] for i in info["sass"]]
            counts[key] = {
                "hgmma": sum(o.startswith("HGMMA") for o in ops),
                "utmaldg": sum(o.startswith("UTMALDG") for o in ops),
                "ublkcp": sum(o.startswith("UBLKCP") for o in ops),
                "instructions": len(info["sass"]),
                "registers": info.get("registers"), "spill": info.get("spill"),
                "wgmma_serialized": kern in serial}
    print(f"[build] {source} kernels (HGMMA, UTMALDG, UBLKCP, SASS "
          f"instructions, registers, spill bytes, wgmma serialized): "
          f"{json.dumps(counts)}", flush=True)
    check(len(counts) == SM90_KERNELS[source],
          f"the built {source} lacks a kernel: {sorted(counts)}")
    check(all(c["hgmma"] > 0 and c["utmaldg"] > 0 for c in counts.values()),
          f"a {source} kernel has no HGMMA or no TMA load: {counts}")
    check(all(c["spill"] == 0 for c in counts.values()),
          f"a {source} kernel spills: {counts}")
    return counts


def _kernel_info(log: str, cubin: pathlib.Path) -> dict[str, dict]:
    """Per kernel (demangled name): registers and stack from ptxas, and the
    SASS instruction text from cuobjdump (addresses and encodings dropped)."""
    info, cur = {}, None
    for line in log.splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            cur = m.group(1)
            info[cur] = {}
        elif cur and _PTXAS_STACK.search(line):
            st = _PTXAS_STACK.search(line)
            info[cur]["stack"], info[cur]["spill"] = int(st.group(1)), int(st.group(2))
        elif cur and _PTXAS_REGS.search(line):
            info[cur]["registers"] = int(_PTXAS_REGS.search(line).group(1))
            sm = _PTXAS_SMEM.search(line)
            info[cur]["smem"] = int(sm.group(1)) if sm else 0
    body = _sass(cubin)
    names = _demangle(sorted(set(info) | set(body)))
    return {names.get(k, k): {**info.get(k, {}), "sass": body.get(k, [])}
            for k in set(info) | set(body)}


def _base_name(kernel: str) -> str:
    """A demangled kernel name without a last template argument ``false``:
    the change may add a ``bool`` template parameter whose ``false``
    instantiation is the parent's kernel."""
    return re.sub(r", (false|\(bool\)0)>\(", ">(", kernel, count=1)


def compare_builds(parent: pathlib.Path, change: pathlib.Path) -> dict:
    """For every kernel the parent builds: its registers, stack and spills
    in both checkouts and whether the change's SASS is identical (matched
    by name, or through ``_base_name`` where the change added a trailing
    ``false`` template argument); plus the kernels only the change
    builds."""
    import tempfile
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for tag, root in (("parent", parent), ("change", change)):
            for name in ("flash_fwd", "flash_decode", "flash_bwd"):
                cub = pathlib.Path(tmp) / f"{tag}-{name}.cubin"
                procs[(tag, name)] = (_cubin(root, name, cub), cub)
        infos = {}
        for key, (proc, cub) in procs.items():
            log, _ = proc.communicate()
            check(proc.returncode == 0, f"nvcc {key} failed:\n{log[-3000:]}")
            infos[key] = _kernel_info(log, cub)
    for name in ("flash_fwd", "flash_decode", "flash_bwd"):
        par, chg = infos[("parent", name)], infos[("change", name)]
        by_base = {_base_name(k): v for k, v in chg.items()
                   if _base_name(k) != k and _base_name(k) not in chg}
        matched = set()
        for kern, p in sorted(par.items()):
            c = chg.get(kern) or by_base.get(kern)
            matched.add(id(c))
            if c is None:
                out[kern] = {"parent": {k: v for k, v in p.items() if k != "sass"},
                             "change": None}
                continue
            out[kern] = {
                "parent": {k: v for k, v in p.items() if k != "sass"},
                "change": {k: v for k, v in c.items() if k != "sass"},
                "sass_instructions": [len(p["sass"]), len(c["sass"])],
                "sass_identical": p["sass"] == c["sass"]}
        out[f"{name}: new kernels"] = sorted(
            k for k, v in chg.items() if id(v) not in matched)
    return out


def ab_main(parent: pathlib.Path, seed: int) -> int:
    card = card_line()
    print(card, flush=True)
    builds = compare_builds(parent, ROOT)
    for kern, rec in builds.items():
        print(f"[ab-build] {kern}: {json.dumps(rec)}", flush=True)
    runs = {"parent": [], "change": []}
    for tag in ("parent", "change", "change", "parent"):
        root = parent if tag == "parent" else ROOT
        code = _AB_RUN.format(src=str(root / "src"), here=str(ROOT), seed=seed,
                              rates=(HBM_BYTES_PER_S, BF16_FLOPS_PER_S,
                                     FP32_FLOPS_PER_S))
        out = subprocess.run([sys.executable, "-c", code], cwd=root,
                             capture_output=True, text=True, timeout=900)
        line = [x for x in out.stdout.splitlines() if x.startswith("AB ")]
        check(out.returncode == 0 and len(line) == 1,
              f"A/B run of {tag} failed: {out.stderr[-2000:]}")
        runs[tag].append(json.loads(line[0][3:]))
        print(f"[ab] {tag}: {line[0][3:]}", flush=True)
    print(json.dumps({"ab": runs, "card": card}))
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_ab.json").write_text(json.dumps(
        {"ab": runs, "builds": builds, "card": card}, indent=1))
    return 0


# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ab", type=pathlib.Path, default=None,
                    metavar="PARENT_CHECKOUT",
                    help="only A/B the serving path against that checkout")
    args = ap.parse_args()
    if not (ROOT / "src" / "repro_torch" / "__init__.py").exists():
        print("chip_smoke: src/repro_torch is not beside this script; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    use_io_model()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test runs only on a CUDA card", file=sys.stderr)
        return 3
    if args.ab is not None:
        return ab_main(args.ab.resolve(), args.seed)
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    cubins = {name: out_dir / f"{name}_ptxas.cubin"
              for name in ("flash_fwd", "flash_fwd_sm90", "flash_bwd",
                           "flash_bwd_sm90", "flash_decode")}
    procs = {name: _cubin(ROOT, name, cub)          # beside the build
             for name, cub in cubins.items()}
    try:
        libs = build.build_all()
    except BaseException:
        for proc in procs.values():
            proc.kill()
            proc.wait()
        raise
    build_s = time.perf_counter() - t0
    print(f"[build] {len(build.SOURCES)} kernel libraries in {build_s:.1f}s",
          flush=True)
    hmma = fwd_build_counts(procs["flash_fwd"], cubins["flash_fwd"])
    hmma_bwd = bwd_build_counts(procs["flash_bwd"], cubins["flash_bwd"])
    sm90_build = sm90_build_counts(procs["flash_bwd_sm90"],
                                   cubins["flash_bwd_sm90"])
    sm90_fwd_build = sm90_build_counts(procs["flash_fwd_sm90"],
                                       cubins["flash_fwd_sm90"],
                                       "flash_fwd_sm90")
    decode_build = decode_build_counts(torch, procs["flash_decode"],
                                       cubins["flash_decode"])

    laps = {}

    def lap(name: str) -> None:
        """Frees what the phase left (``release``) and notes when it
        ended, in seconds since the start."""
        release(torch)
        laps[name] = time.perf_counter() - t_start
        print(f"[time] {name} ended at {laps[name]:.1f}s", flush=True)

    kernels = kernel_phase(torch, args.seed)
    bwd_kernels, fwd_train = train_kernel_phase(torch, args.seed)
    kernels[0]["at_train_shape"] = fwd_train
    kernels += bwd_kernels
    kernels += paged_grad_kernel_phase(torch, args.seed)
    lap("kernels")
    at_shapes = new_shape_kernel_phase(torch, args.seed)
    for name, entries in train_mesh_kernel_phase(torch, args.seed).items():
        at_shapes.setdefault(name, {}).update(entries)
    lap("kernels_at_shapes")
    sparse_at, paths = blocksparse_phase(torch, args.seed)
    lap("blocksparse")
    for extra in (sparse_at, seamless_kernel_phase(torch, args.seed)):
        for name, entries in extra.items():
            at_shapes.setdefault(name, {}).update(entries)
    lap("seamless_kernels")
    for name, entries in phi3v_kernel_phase(torch, args.seed).items():
        at_shapes.setdefault(name, {}).update(entries)
    lap("phi3v_kernels")
    for name, entries in kvseq_kernel_phase(torch, args.seed).items():
        at_shapes.setdefault(name, {}).update(entries)
    lap("kvseq_kernels")
    moe_layer = moe_layer_phase(torch, args.seed, card)
    lap("moe_layer")
    ssm_layer = ssm_layer_phase(torch, args.seed, card)
    lap("ssm_layer")
    paths["paged_grad"] = paged_grad_phase(torch, args.seed)
    lap("paged_grad")
    parity = parity_phase(torch, args.seed)
    serve, paths["serve"] = serve_phase(torch, args.seed, card)
    lap("serve")
    dense_parity = dense_parity_phase(torch, args.seed)
    dense_serve, paths["dense_serve"] = dense_serve_phase(torch, args.seed,
                                                          card)
    lap("dense_serve")
    train_parity = train_parity_phase(torch, args.seed)
    train, paths["train"] = train_phase(torch, args.seed, card,
                                        state_bytes=True)
    lap("train")
    bert_parity = train_parity_phase(torch, args.seed, "bert-large",
                                     lamb_recipe, tag="bert-parity")
    train_bert, paths["train_bert"] = bert_train_phase(torch, args.seed, card)
    lap("train_bert")
    olmo_parity = train_parity_phase(torch, args.seed, "olmo-1b",
                                     tag="olmo-parity")
    train_olmo, paths["train_olmo"] = train_phase(
        torch, args.seed, card, arch="olmo-1b", tag="train-olmo")
    lap("train_olmo")
    qwen3_parity = parity_phase(torch, args.seed, "qwen3-32b", n_new=8,
                                tag="qwen3-parity")
    lap("qwen3_parity")
    serve_qwen3, paths["serve_qwen3"] = serve_phase(
        torch, args.seed, card, arch="qwen3-32b",
        num_layers=SERVE_QWEN3_LAYERS, tag="serve-qwen3", hold_shapes=True)
    lap("serve_qwen3")
    olmoe_train_parity = moe_train_parity_phase(
        torch, args.seed, "olmoe-1b-7b", tag="olmoe-train-parity")
    lap("olmoe_train_parity")
    olmoe_parity = parity_phase(torch, args.seed, "olmoe-1b-7b", n_new=8,
                                tag="olmoe-parity")
    lap("olmoe_parity")
    serve_olmoe, paths["serve_olmoe"] = serve_phase(
        torch, args.seed, card, arch="olmoe-1b-7b", tag="serve-olmoe",
        hold_shapes=True)
    lap("serve_olmoe")
    phi35moe_train_parity = moe_train_parity_phase(
        torch, args.seed, "phi3.5-moe-42b-a6.6b", tag="phi35moe-train-parity")
    lap("phi35moe_train_parity")
    phi35moe_parity = parity_phase(torch, args.seed, "phi3.5-moe-42b-a6.6b",
                                   n_new=8, tag="phi35moe-parity")
    lap("phi35moe_parity")
    serve_phi35moe, paths["serve_phi35moe"] = serve_phase(
        torch, args.seed, card, arch="phi3.5-moe-42b-a6.6b",
        num_layers=SERVE_PHI35MOE_LAYERS, tag="serve-phi35moe",
        hold_shapes=True)
    lap("serve_phi35moe")
    train_olmoe, paths["train_olmoe"] = olmoe_train_phase(torch, args.seed,
                                                          card)
    lap("train_olmoe")
    mamba2_parity = recurrent_parity_phase(torch, args.seed, "mamba2-2.7b",
                                           tag="mamba2-parity")
    lap("mamba2_parity")
    serve_mamba2, paths["serve_mamba2"] = dense_serve_phase(
        torch, args.seed, card, arch="mamba2-2.7b", tag="serve-mamba2",
        long_prompt=RECURRENT_LONG_PROMPT, kernels=(), profiled=True)
    lap("serve_mamba2")
    train_mamba2, paths["train_mamba2"] = train_phase(
        torch, args.seed, card, arch="mamba2-2.7b", tag="train-mamba2",
        kernels=())
    lap("train_mamba2")
    hymba_parity = recurrent_parity_phase(torch, args.seed, "hymba-1.5b",
                                          tag="hymba-parity")
    lap("hymba_parity")
    serve_hymba, paths["serve_hymba"] = dense_serve_phase(
        torch, args.seed, card, arch="hymba-1.5b", tag="serve-hymba",
        long_prompt=RECURRENT_LONG_PROMPT, profiled=True)
    lap("serve_hymba")
    train_hymba, paths["train_hymba"] = train_phase(
        torch, args.seed, card, arch="hymba-1.5b", tag="train-hymba")
    lap("train_hymba")
    seamless_parity = seamless_parity_phase(torch, args.seed)
    lap("seamless_parity")
    serve_seamless, paths["serve_seamless"] = seamless_serve_phase(
        torch, args.seed, card)
    lap("serve_seamless")
    train_seamless, paths["train_seamless"] = seamless_train_phase(
        torch, args.seed, card)
    lap("train_seamless")
    phi3v_parity = phi3v_parity_phase(torch, args.seed)
    lap("phi3v_parity")
    serve_phi3v, paths["serve_phi3v"] = phi3v_serve_phase(torch, args.seed,
                                                          card)
    lap("serve_phi3v")
    train_phi3v, paths["train_phi3v"] = phi3v_train_phase(torch, args.seed,
                                                          card)
    lap("train_phi3v")
    tp_serving, tp_paths = tp_serving_phase(torch, args.seed, card)
    paths.update(tp_paths)
    lap("tp_serving")
    train_mesh, mesh_paths = train_mesh_phase(torch, args.seed, card)
    paths.update(mesh_paths)
    lap("train_mesh")
    train_family, family_paths = train_family_phase(torch, args.seed, card)
    paths.update(family_paths)
    lap("train_family")
    levers, levers_paths = levers_phase(torch, args.seed, card)
    paths.update(levers_paths)
    lap("levers")
    kvseq, kvseq_paths = kvseq_phase(torch, args.seed, card)
    paths.update(kvseq_paths)
    lap("kvseq")
    serves = {"serve_qwen3": serve_qwen3, "serve_olmoe": serve_olmoe,
              "serve_phi35moe": serve_phi35moe, "serve_hymba": serve_hymba}
    held = serve_shape_records_apart(torch, args.seed, {
        path: (path.replace("_", "-"), rec.pop("calls"))
        for path, rec in serves.items()})
    for path, entries in held.items():
        for name, entry in entries.items():
            at_shapes.setdefault(name, {})[path] = entry
    lap("serve_shape_records")
    # last: after its CLI runs (child processes on the card) one run's
    # torch.profiler recorded no whole window in ten tries
    tuning_rec = tuning_phase(torch, args.seed, card)
    lap("tuning")
    for name in TRAIN_KERNELS:       # train-olmoe's attention is train-olmo's
        at_shapes[name]["train_olmoe"] = dict(at_shapes[name]["train_olmo"])
    for rec in kernels:
        by_path = {p: launches[rec["name"]] for p, launches in paths.items()}
        rec["launches"] = sum(by_path.values())
        rec["launches_by_path"] = by_path
        if rec["name"] in at_shapes:
            rec["at_shapes"] = at_shapes[rec["name"]]
            for path, entry in rec["at_shapes"].items():
                entry["launches"] = by_path[path]
    check(all(rec["launches"] > 0 for rec in kernels
              if rec.get("on_main_path", True)),
          "a kernel was launched on none of the main paths")
    check(all(rec["launches"] == 0 for rec in kernels
              if not rec.get("on_main_path", True)),
          "a main path launched an mma.sync body of the bf16 forward or of "
          "the backward pair (contiguous or paged)")

    record = {"card": card, "build_s": build_s, "hmma": hmma,
              "bwd_bf16_build": hmma_bwd, "bwd_sm90_build": sm90_build,
              "fwd_sm90_build": sm90_fwd_build,
              "decode_build": decode_build,
              "kernels": kernels,
              "paged_grad_launches": paths["paged_grad"], "parity": parity,
              "serve": serve, "dense_parity": dense_parity,
              "dense_serve": dense_serve, "train_parity": train_parity,
              "train": train, "bert_parity": bert_parity,
              "train_bert": train_bert, "olmo_parity": olmo_parity,
              "train_olmo": train_olmo, "qwen3_parity": qwen3_parity,
              "serve_qwen3": serve_qwen3, "moe_layer": moe_layer,
              "olmoe_train_parity": olmoe_train_parity,
              "olmoe_parity": olmoe_parity, "serve_olmoe": serve_olmoe,
              "phi35moe_train_parity": phi35moe_train_parity,
              "phi35moe_parity": phi35moe_parity,
              "serve_phi35moe": serve_phi35moe, "train_olmoe": train_olmoe,
              "ssm_layer": ssm_layer, "mamba2_parity": mamba2_parity,
              "serve_mamba2": serve_mamba2, "train_mamba2": train_mamba2,
              "hymba_parity": hymba_parity, "serve_hymba": serve_hymba,
              "train_hymba": train_hymba,
              "blocksparse": {p: at_shapes["flash_fwd_sm90"][p]
                              for p in BLOCKSPARSE},
              "seamless_parity": seamless_parity,
              "serve_seamless": serve_seamless,
              "train_seamless": train_seamless,
              "phi3v_parity": phi3v_parity, "serve_phi3v": serve_phi3v,
              "train_phi3v": train_phi3v, "tp_serving": tp_serving,
              "train_mesh": train_mesh, "train_family": train_family,
              "levers": levers, "kvseq": kvseq, "tuning": tuning_rec, "phase_end_s": laps,
              "total_s": time.perf_counter() - t_start}
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(f"[done] total {record['total_s']:.1f}s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
