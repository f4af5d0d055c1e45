#!/usr/bin/env python3
"""Bring-up check of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py

Drives the port in phases and exits non-zero if any fails:

  (a) device   needs CUDA; prints the card's name and power limit; TF32 off;
  (b) build    builds the CUDA flash-attention, grouped-matmul, SSD-scan and
               RG-LRU-scan kernels from src/repro_torch/csrc with nvcc for
               sm_90a, one nvcc per source, started together; prints each
               kernel's registers, static shared memory and spills (fails
               on a spill in a bf16 tensor-core kernel or in a kernel of
               either scan), and the dynamic shared memory a block of
               each path of flash and moe_gmm takes (bf16 runs on the
               tensor cores, flash's and moe_gmm's f32 too, in split TF32,
               where TMA can address the tensors; flash's f32 at D 16 / 32
               and moe_gmm's f32 at shapes TMA cannot address on the FMA
               kernels) and a block of ssd_scan's chunk-parallel scan
               takes; fails on a spill in flash_fwd_tf32x3 and gmm_tf32x3
               too, unless each instantiation of the five wgmma paths
               (flash_fwd_wgmma, flash_fwd_tf32x3: split-TF32 wgmma,
               gmm_wgmma, moe_gmm's decode path gmm_swap_wgmma, moe_gmm's
               f32 path gmm_tf32x3: split-TF32 wgmma) and of ssd_scan's
               two kernels
               (ssd_cb, ssd_chunk: split-TF32 wgmma) holds HGMMA and
               UTMALDG in its SASS, and on a wgmma ptxas serialised (C7518
               in the nvcc log);
  (c) kernel   holds the flash kernel against its plain PyTorch version on
               the shapes of tests/test_kernels.py and on the serve paths'
               prefill shapes (qwen2-7b: Hq 28, Hkv 4, D 128; olmoe-1b-7b:
               Hq = Hkv = 16, D 128; causal, S 32/200/1024; recurrentgemma-
               9b: Hq 16, Hkv 1, D 256, window 2048, S 32/200/300/1024, and
               a window of 256 that binds at S 1024; internvl2-1b: Hq 14,
               Hkv 2, D 64, causal, at each of (m)'s prompts, S 288/456/
               1024/556; whisper-base: Hq = Hkv = 8, D 64, the encoder's
               non-causal 1500 x 1500, and at each of (n)'s decoder prompts,
               4/32/200/300, the decoder's causal self-attention and its
               non-causal cross-attention, Sq x Sk 1500), and on the edges of
               the bf16 tensor-core paths (S not a multiple of 16, 64 or
               128, Sq = 1, Sq != Sk, every head dim, GQA groups
               1/4/7/8/16/48, rows all masked in a kv tile), f32 and bf16,
               tolerance 2e-5 (f32) / 3e-2 (bf16); fails if a call takes
               another path than ops.flash_path gives (bf16 D >= 64:
               wgmma; f32 D >= 64: tf32x3); times kernel, plain version
               and torch's scaled_dot_product_attention (a yardstick the
               port never calls; f32 with TF32 off) with CUDA events,
               beside the bound, with the kernel / library ratio and the
               achieved TFLOP/s and TB/s, and kernel and SDPA in CUDA
               graphs with the share of the bound (f32: of the split-TF32
               bound, three TF32 products at 495 TFLOP/s, and of the
               FMA-rate bound, 67 TFLOP/s);
  (c2) kernel  holds moe_gmm against its plain version on the shapes of
               tests/test_kernels.py, two ragged ones, the edges of the
               bf16 tensor-core paths (C of 1, 8, 9 and 160, D and F not
               multiples of 8 with the fill path's 8- and 16-row tiles,
               every count 0, every count C; the swap path's C of 1, 7, 8,
               9, 16 and its split over D at 1, 2, 4 and 8 blocks on
               EP-shaped calls) and
               olmoe-1b-7b's serve shapes (decode C=8 with 32 of 64 experts in use, prefill
               C=160 and C=48 with counts from routing 1024 and 300 random
               tokens), f32 and bf16, inputs at the model's scale; tolerance
               1e-4 (f32, TF32 off) / 3e-2 (bf16: output rounding); the f32
               "tf32x3" path's edges too (C of 1, 7, 9, 16, 17, 48, 65,
               160, 2560; D and F multiples of 4 but not 8; every split
               over D); fails if a call takes another path than
               ops.gmm_path gives (f32: tf32x3 but on the ragged shape), if
               a row past counts[e] is not exactly zero, if two swap- or
               tf32x3-path calls differ in a bit, if a swap-path call is
               more than one bf16 ulp (and 1e-4) from the plain version of
               its split over D, or a tf32x3 call more than 1e-4 from the
               plain version of its own arithmetic (ref.gmm_tf32x3_
               reference); f32 rows beside both f32 bounds (split TF32 and
               the FMA rate); times
               kernel, plain version and torch.bmm on the capacity buffer (a
               yardstick the port never calls) beside the bound, which counts
               the rows in use and the weights of the experts in use only,
               with the kernel / library ratio, TFLOP/s and TB/s;
  (c3) kernel  holds ssd_scan (y and the final state h) against its plain
               version (the chunked scan of the JAX model) on the shapes of
               tests/test_kernels.py, two ragged ones (S not a chunk
               multiple), the chunk-parallel kernel's structure (8 and 16
               chunks at S 2048 and 4096, B=4 at mamba2's widths, P of 40),
               the edges of its 64-row tiles (S 1, 7, 33, 65; P 8, 24,
               40; N 8, 40; B 4; S 150, 230: one chunk split over two
               blocks),
               strong
               decay (unit-scale inputs, A dt down to about -60 a step)
               and mamba2-1.3b's
               serve shapes (B=1, H 64, P 64, N 128, chunk 256, S 32/200/
               300/1024), f32 and bf16, inputs at the model's scale, TF32
               off; tolerance atol 1e-3 (f32, as tests/test_kernels.py) and
               for bf16 y also rtol 2^-8 (y is rounded to bf16 once: half an
               ulp is 2^-9 of |y|); times kernel and plain version beside
               the bound, the kernel also in a CUDA graph (device time
               only: back-to-back calls of a short kernel time its
               wrapper's host dispatch), with the achieved GFLOP/s and the
               share of the bound on the device time (no single PyTorch
               call computes this function, so no library time); the f32
               bound is at the split-TF32 rate (three products at 495
               TFLOP/s), printed beside the FMA-rate bound (67 TFLOP/s);
  (c4) kernel  holds rglru_scan (every h and the last, f32) against its
               plain version (the sequential recurrence in f32) on the shapes
               of tests/test_kernels.py (strong decay included), two ragged
               ones with an initial state, the chunk-parallel kernel's
               edges (S of 1, 7, 9, 257 and 4096 around its 8-step chunks
               and 256-step rounds, C of 4097, B=4 with h0) and
               recurrentgemma-9b's serve shapes (B=1, C 4096, S 32/200/300/
               1024, log_a and gx at the model's scale), f32 and bf16;
               tolerance atol 1e-5 (as tests/test_kernels.py) and for bf16 h
               also rtol 2^-8 (h is rounded to bf16 once); times kernel and
               plain version beside the bound, and the kernel in a CUDA
               graph as in (c3), with the achieved GB/s and the share of
               the bound on the device time (no single PyTorch call
               computes this recurrence);
  (c5) kernel  holds the flash kernel with a logit softcap (each scaled
               score s becomes c tanh(s / c) before the mask, JAX's
               layers.attention softcap) against its plain version at (c)'s
               tolerances: qwen2-7b's S 1024 causal, recurrentgemma-9b's D
               256 under its 2048 window, whisper-base's non-causal cross
               shape Sq 300 x Sk 1500, qwen2-7b's last context-parallel rank
               of 4 (q_offset 768) and granite-20b's multi-query shape (Hq
               48 on one kv head), each at c = 1.0 and 50.0 (Gemma 2's),
               bf16 and f32, one launch a call; bf16 scores drawn with a
               spread of 1 (c = 1) or 3 (c = 50) so that the cap bends
               them, and V with a spread of 8 (f32: N(0, 1) inputs; its
               tolerance is 1500 times finer): the plain version without
               the cap, with
               the cap on the unscaled score, with the capped score scaled
               again and (c = 50) with c tanh(s) must each differ from the
               kernel by more than the tolerance; times kernel, plain
               version and FlexAttention with the cap as its score_mod
               (torch.compile'd; the library time, never called by the
               port) beside the bound; the f32 cases also kernel and
               FlexAttention in CUDA graphs beside both f32 bounds;
  (c6) kernel  holds mamba2's prefill glue, ssm_conv_act (the causal convs
               of x, B and C with SiLU, softplus of dt, the conv states)
               and ssm_gate_norm (the D skip, the gate and the gated
               RMSNorm), against their plain versions (models.mamba2.
               _conv_act / _gate_norm) at mamba2-1.3b's widths (d_inner
               4096, N 128, 64 heads of 64): (d3)'s batch-1 prefills (S 32,
               200, 1024, 300) in f32 and bf16 and the benchmark's B 8 S
               2048 in bf16, one launch a call, at tests/test_torch_ssm_
               glue.py's bounds (the conv within the plain version's bf16
               rounding and within one rounding of a float64 conv, the
               states exact; the norm within four steps of the dtype, in
               bf16 under 1e-3 of the elements differing); times kernel
               and plain version back to back and the kernel in a CUDA
               graph beside its bytes bound at 3.35 TB/s;
  (d) serving  qwen2-7b at full width and depth in bf16, random weights from
               a seed drawn on the card, served through repro_torch.launch.
               serve.run (GangExecutor -> ServingEngine -> dense transformer
               with the flash kernel as its prefill attention): 6 requests of
               mixed prompt lengths, 16 new tokens each; every request must
               finish and the launch counts over the run must be n_layers x
               prefills (flash) and 0 (moe_gmm); here and in every serve,
               gang and serve+train phase each bf16 flash launch must take
               the wgmma path;
  (e) oracle   the engine's greedy tokens equal a greedy rollout that
               re-prefills the whole sequence each step (port against port),
               at full width in f32 on the same weights, where the two paths
               agree to rounding and near-ties cannot flip the argmax;
  (d2) serving olmoe-1b-7b (64 experts, top-8) at full width and depth in
               bf16, the same way and the same 6 prompts: the flash kernel is
               the prefill attention and moe_gmm the expert FFN; launch
               counts must be n_layers x prefills (flash) and 3 x n_layers x
               (prefills + decode steps) (moe_gmm), each moe_gmm launch on
               wgmma (C > 16) or swap, none on fill, fma or tf32x3;
  (e2) oracle  the f32 engine's tokens equal a one-request-at-a-time rollout
               through prefill_fn then decode_fn at batch 1. Not the
               re-prefill oracle of (e): a re-prefill routes every earlier
               token again under a capacity that grows with the sequence,
               so the MoE layer may drop other (token, expert) pairs than the
               engine did (JAX's semantics, not a fault); a decode step
               routes at most B <= 8 tokens to an expert whose capacity is 8,
               so it never drops, and the batch-1 rollout and the slot engine
               compute the same function. Random weights give near-constant
               greedy tokens, so the tokens alone check little: then the f32
               logits through the kernels equal those through the kernels'
               plain versions within 1e-3, at a prefill and at 4 decode steps
               over 4 slots at different positions (capacity buffers of 8
               rows, moe_gmm at C=8, in-place cache writes), and so do the
               caches after them; every moe_gmm launch of the phase must
               take the tf32x3 path (its count by path printed);
  (d5) serving granite-20b (multi-query: 48 q heads on one kv head, 52
               layers, 28.2 B parameters) at full width and depth in bf16,
               as (d): every request finished, flash launched n_layers x
               prefills, the other kernels never; peak memory printed;
  (e5) oracle  (e) for granite-20b in f32 on the first 4 of its 52 layers
               of the same weights (10.9 GB; all 52 would be 113 GB), and
               the logits and caches through the kernel against the plain
               versions within 1e-3 as (e2) checks them;
  (d6) serving minitron-4b (GQA 24 over 8, a 256,000-entry vocabulary, 32
               layers) at full width and depth in bf16, as (d);
  (e6) oracle  (e5) for minitron-4b at full depth in f32 (20.4 GB);
  (x) softcap  qwen2-7b at full width with logit_softcap 1.0, 4 of its 28
               layers, f32 from seed 0: a prefill and 4 decode steps over 4
               slots, and a 300-token prefill, through the kernel against
               the same calls through the plain versions within 1e-3
               (logits and caches); flash launched exactly 4 x 6 times;
               the same weights without the cap must give other logits;
  (d3) gang    mamba2-1.3b (SSM) at full width and depth in bf16, random
               weights from seed 0 drawn on the card, through ModelApi.
               prefill_fn / decode_fn (the slot engine serves attention
               caches only, as in JAX): the batched decode step over 4
               sequences is the RT job of a GangExecutor (one step per
               quantum on lane 0, through device.Lanes.on_lane) beside the
               best-effort 512^2 matmul job on lanes 0 and 1, bound by
               launch/serve.run_gang as serve.run binds the engine's step;
               the first quantum prefills prompts of 32, 200, 1024
               and 300 tokens at batch 1 and concatenates their state
               caches; then each quantum decodes until every sequence has
               16 new tokens. ssd_scan must launch n_layers x prefills
               times, the glue 2 x n_layers x prefills (ssm_conv_act and
               ssm_gate_norm), the other kernels never; then, alone, 12
               decode steps must launch no kernel and 4 prefills 4 x 96
               glue and 4 x 48 scan launches;
  (e3) oracle  at full width in f32: the logits through the kernel equal
               those of the same calls with ssd_scan swapped for its plain
               version within 1e-3, at the 4 prefills and at 4 decode steps
               over the 4 sequences, and so do the caches after them; each
               sequence's batched greedy tokens equal its batch-1 rollout
               (prefill_fn, then decode_fn); how far they equal a re-prefill
               rollout is reported (they agree up to rounding);
  (d4) gang    recurrentgemma-9b (RG-LRU + local attention hybrid, 38
               layers: 12 groups of (rec, rec, attn) and 2 rec) at full
               width and depth in bf16, the same way and the same prompts;
               the attention layers' k/v go into (12, 4, 2048, 1, 256)
               buffers at rows [0, len), zeros beyond, the rec caches are
               concatenated. rglru_scan must launch 26 x 4 times, flash
               12 x 4, moe_gmm and ssd_scan never;
  (e4) oracle  as (e3) at full width in f32, with both scans' and the flash
               kernel's plain versions, every cache leaf after the prefills
               and after the decode steps checked;
  (m) gang     internvl2-1b (vlm: Qwen2-0.5B-like LM, 24 layers, the stub
               vision tower's patches in the first 256 positions) at full
               width and depth in bf16 the same way: batch-1 prefills of
               288 / 456 / 1024 / 556 tokens (256 patch positions, patches
               normal x 0.02 from a seed, plus 32 / 200 / 768 / 300 text
               tokens), k/v padded into (24, 4, 2048, 2, 64) buffers, then
               the batched decode step as the RT gang until 16 tokens each.
               flash must launch exactly 24 x 4 times, the others never
               (the slot engine prefills tokens only, as JAX's: the gang
               is the batched decode_fn, as for mamba2 and recurrentgemma);
  (m2) oracle  as (e4) at full width in f32, every cache leaf; and each
               sequence's last-token decode after a prefill of the rest
               against the full prefill within 2e-3; the patches scaled by
               -5 must move the logits and the k cache by more than 1e-3;
  (n) gang     whisper-base (audio: 6 encoder + 6 decoder layers, 1500 stub
               frames a prompt, normal x 0.02) the same way: decoder
               prompts of 4 / 32 / 200 / 300 tokens, the self cache padded
               into (6, 4, 448, 8, 64) buffers (whisper's decoder context),
               cross K/V (6, 4, 1500, 8, 64) concatenated; flash must
               launch exactly 18 x 4 times (6 encoder layers, non-causal
               1500 x 1500; 6 decoder self, causal; 6 cross, Sq x 1500),
               the others never; decode's cross-attention reads the cached
               K/V in torch ops (JAX has no kernel there either);
  (n2) oracle  as (m2) for whisper-base, cross_k / cross_v included, the
               frames scaled by -5 moving the logits and cross_k;
  (f) dave2    the paper's DAVE-2 control-loop CNN (repro_torch.models.
               dave2, f32, TF32 off) on the card at B=1 and B=8, random
               images from a seed, against the same module on the CPU with
               the same weights, atol 1e-5: once with make_dave2's weights
               (the init rule, seed 0) and once with weights at std
               1/sqrt(fan_in) and nonzero biases, where tanh does not
               saturate; the B=1 forward's time back to back (CUDA events)
               and in a CUDA graph (device time), and its device launches
               and busy time a forward (torch.profiler);
  (g) fig1     repro_torch.benchmarks.fig1_parallelization.run() (the batch
               of 8 split over 1/2/4 streams; the DNN solo and beside a
               1024^2 memory co-runner thread on a stream of its own), then
               one co-run traced with torch.profiler: fails unless the
               co-runner's kernels run beside the DNN's;
  (h) fig6     repro_torch.benchmarks.fig6_dnn_cdf.run(duration=6): the
               DAVE-2 quantum's p50/p95/p99/max, n and best-effort quanta
               under Solo, Co-Sched and RT-Gang on the executor, and its
               time on the lane's stream (CUDA events) beside p50 and p99;
               fails if a mode ran no DNN quantum or a quantum raised. The
               latency ordering is reported, not checked. Then the DNN
               alone on the executor at its period (the baseline RT-Gang
               can match: Solo's calls run back to back), and each mode
               again under torch.profiler: the DNN's kernels' busy time a
               quantum and its overlap with the best-effort kernels. None
               of the four kernels may launch in (f)-(h);
  (i) vgang    virtual gangs on the card: repro_torch.benchmarks.
               bench_executor_vgang at its full default duration with
               --reclaim (solo, vgang, rtgT, rtgT+dr; five members whose
               quanta are 3 x tanh(x @ x) * 0.5 on 64-160^2 f32 tensors on
               their lanes' CUDA streams), its JSON in build/; fails on a
               max response above its RTA bound, an RTA verdict not ok, a
               member with no response, a gang-invariant or budget-ordering
               violation or a raised quantum, and, from each quantum's CUDA
               events on its lane's stream, on any quantum of one vgang
               overlapping one of another vgang on the device (reports how
               long members of one vgang ran side by side); then
               repro_torch.examples.vgang_fleet for 2 s plain, with
               --rtg-throttle and with --reclaim: fails unless the gang
               invariant holds and every member ran jobs;
  (j) rta      the batched RTA's torch backend (float64 lockstep fixed
               point on the card) against its numpy backend on the 500
               seeded task sets of tests/test_batched_rta.py (also with
               blocking and CRPD) and on the vgang grid's full default
               shard (3 core counts x 3 width distributions x 9
               utilizations x 50 sets = 4050 sets, up to 11 gangs each),
               and vgang/rta's batched_accepts through it: fails unless
               every verdict is equal, the same lanes settle and every
               finite WCRT agrees within a relative 1e-12; reports both
               backends' times. None of the four kernels may launch in (i)
               or (j);
  (k) train    qwen2-7b at full width, depth cut 28 -> 8 layers (2.954 B
               parameters: 53 GB of f32 AdamW state with bf16 compute; 28
               layers would be 137 GB), through repro_torch.training's
               TrainRunner: f32 masters, bf16 compute, AdamW, remat "block",
               the synthetic TokenSource at B=4, S=1024, 30 steps, no
               checkpoint; reports the step time (median without the first
               3), tokens/s, 6 N tokens / step time against 989 TFLOP/s,
               peak memory, the loss first -> last and the four kernels'
               launches, and one more step under torch.profiler (device
               busy time, idle share, the top kernels); fails unless the
               loss is finite and falls and no kernel launches (JAX's
               training reaches no Pallas kernel).
               Then one f32 loss + gradient at full width (2 layers, B=1,
               S=256, TF32 off) on the card and on the CPU from the same
               weights: the loss within 1e-5 relative, every gradient leaf
               within 1e-4 of that leaf's largest |g|; and the restart path
               at reduced size under build/ (fail at step 10, resume from
               the step-8 checkpoint): every loss within 1e-5 relative of
               the uninterrupted run's;
  (l) serve+train  repro_torch.examples.serve_with_background_training.run
               at full width, under RT-Gang and under Co-Sched, 6 s each:
               the RT gang serves qwen2-7b bf16 at full depth (8 requests
               of 16-token prompts, 12 new tokens, max_batch 2, max_seq
               128), the BE job trains olmoe-1b-7b at full width, depth cut
               16 -> 4 (f32 masters, bf16 compute, AdamW, 4 x 64 tokens a
               microstep); reports per mode the decode quantum's time and
               response p50/p99/max, requests finished, microsteps and
               their median, be_quanta, and from CUDA events on both lanes'
               streams the share of decode stream time beside a microstep;
               fails on a raised quantum, a mode with no decode quantum, a
               non-finite loss, Co-Sched with no microstep (RT-Gang admits
               none once the gang leads: 1e6 B declared a microstep against
               the gang's 5e5 B budget, as in JAX's example) or launch
               counts other than flash = 28 x prefills and 0 for the rest;
  (o) smoke    scripts/torch_smoke_one.py on the card for qwen2-7b,
               olmoe-1b-7b, mamba2-1.3b, recurrentgemma-9b, internvl2-1b and
               whisper-base (one AdamW step, a prefill and a decode step of
               each reduced config, all finite); then one f32 loss +
               gradient of reduced internvl2-1b and reduced whisper-base
               (the data pipeline's batch with patches / frames, B=2, S=32)
               on the card and on the CPU from the same weights, at (k)'s
               tolerances (whisper's key-bias gradients, zero in exact
               arithmetic without RoPE, held to 1e-6 of the largest |g| on
               either side instead), with no kernel launch.
  (p) grid     the port's virtual-gang grid (repro_torch.vgang.grid) on
               configs/experiments/grid_smoke.json, once with the batched RTA
               on numpy and once on its float64 torch backend on the card
               (the cells in this process; the backend's call counter must
               move), each under build/: fails unless both run every cell
               and give equal rows; then the port's schedulability sweep
               (repro_torch.launch.sweep) on sweep_smoke.json into build/,
               failing where RTA accepts more sets than the exact simulation
               runs without a miss. (j)'s task sets come from the port's
               sweep and grid (random_gang_taskset, random_vgang_taskset,
               taskset_seed, n_tasks_for). No kernel may launch in (p);
  (q) perfetto the executor trace of (h)'s traced RT-Gang run exported as a
               Perfetto / Chrome trace (repro_torch.obs.perfetto) to
               build/perfetto_fig6_rtgang.json: fails on any message of
               validate_chrome_trace and unless the file's core tracks
               (segments_from_json) equal the trace's labeled segments;
  (r) roofline inside (d), (d2), (d3), (d4), (m), (n) and (f), on the weights
               already on the card: the port's cost analysis
               (repro_torch.roofline.op_analysis) of the decode step the
               phase times and of its longest prefill (DAVE-2: the B=1
               forward, whose FLOPs must equal the layer formula's), the
               FLOPs, bytes, H100 compute / memory / collective terms
               (repro_torch.roofline.report: 989 TFLOP/s bf16, 67 TFLOP/s
               f32, 3.35 TB/s), the bound in ms, the measured time and the
               share of the bound it reaches, beside the card's name and
               power limit; an analysis restores the launch counts. At the
               end, the reduced config of each of the six families in f32
               from the same weights: a prefill and a decode step analysed
               on the card and on the CPU must give the same FLOPs and
               bytes, and the same kernel work charged;
  (s) cp       the context-parallel flash call per rank, bf16 and f32:
               qwen2-7b (Hq 28, Hkv 4, D 128, causal) at S 1024 over 4 and
               16 ranks and recurrentgemma-9b (Hq 16, Hkv 1, D 256, window
               2048) at S 4096 over 16 ranks; rank r's S / n query rows
               against the full K/V with q_offset = r S / n, each held
               against the plain version at (c)'s tolerances, the ranks
               concatenated against the unsplit call, exactly n launches a
               split; each rank's time (CUDA events, mean of 20 calls), its
               bound (flash_work with the offset) and SDPA over the first
               q_offset + S / n keys with the bottom-right causal mask, and
               the slowest rank against the unsplit call; f32 ranks also
               kernel and SDPA in CUDA graphs beside both f32 bounds;
  (t) ep       moe_gmm at olmoe-1b-7b's expert-parallel shapes under EP 16
               (4 experts a device): the all-to-all receive buffer of a
               1024-token prefill rank (4, 16 x 160, 2048) and the
               replicated decode's (4, cap, 2048) of 8 tokens under both
               capacity formulas (cap_mult 4.0: 16 rows, 2.0: 8), both
               SwiGLU products, every row counted, bf16 and f32, against
               the plain version, f32 on the tf32x3 path; times beside the
               bound (f32: both f32 bounds) and torch.bmm;
  (u) dryrun   repro_torch.launch.dryrun on qwen2-7b train_4k / prefill_32k
               / decode_32k (the cp recipe), olmoe-1b-7b train_4k /
               decode_32k (tp attention, FSDP, the all-to-all and the
               replicated experts) on 16x16 and kimi-k2-1t-a32b decode_32k
               on pod2x16x16, one fake-backend process each, all at once
               (no device memory; qwen2-72b train_4k traces for ~150 s and
               is left to the sweep); fails on a missing key, on a cell
               with no collective, or on a train cell more than 2x from 8
               N_active tokens / chips; prints the roofline bench's table
               of the cells (H100 model terms, not times). No kernel may
               launch in (u).

               Also mamba2-1.3b prefill_32k (its scan under shard_map
               over the heads), recurrentgemma-9b long_500k (batch 1,
               replicated over data) and whisper-base train_4k (8 heads
               over model 16: the cp recipe).
  (w) bench    the port's aggregator (repro_torch.benchmarks.run, the
               counterpart of benchmarks/run.py) on the card with fig6 at
               1 s a mode: fails unless each section printed in order, each
               Fig.6 mode ran a DNN quantum and the roofline section read
               every cell (u) wrote; no kernel may launch;
  (v) mesh     the sharded path on the card: a one-rank NCCL group and a
               DeviceMesh("cuda", (1, 1)), the models built sharded=True
               on it (every leaf a DTensor, every parallel path on its
               shard_map body); mamba2-1.3b and recurrentgemma-9b at full
               width and depth, f32, one 200-token prompt each: logits and
               every cache leaf equal to the same prefill without a mesh
               (atol 1e-3 as (c3), 1e-5 as (c4)), exactly 48 ssd_scan, 26
               rglru_scan and 12 flash_attention launches a prefill, and
               no glue launch (on a mesh mamba2 keeps the glue's plain
               ops); then
               a reduced recurrentgemma training state, one step in on the
               mesh, saved and restored through the mesh-aware
               checkpoint/ckpt.py onto the mesh and onto one device, bit
               for bit.

(d) and (d2) build on launch.mesh.make_local_mesh(1, 1): the mesh code
with every parallel path on its one-device branch.

Every f32 phase ((e)-(e6), (m2), (n2), (x), (v)) prints flash's launches
by path and fails unless each is on tf32x3 (every shipped config's head
dim is 64 or more).

Each serving and training phase sets the kernels' launch counts to 0
just before it drives the path and reads them just after; ssd_scan must
launch 0 times on every path but mamba2-1.3b's, rglru_scan on all but
recurrentgemma-9b's, moe_gmm on all but olmoe-1b-7b's, the glue (ssm_glue)
on all but mamba2-1.3b's prefills off a mesh. Before the last line it prints
one JSON object {"kernels": [...]} with each kernel's launches on the serve
paths, error, times and bound (``ms`` from calls back to back, and for the
two scans and the two glue kernels also ``graph_ms``, the device time in a
CUDA graph); the last
line is {"ok": true, "device": {...}}. Details go to build/chip_smoke.json.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import io
import importlib.util
import json
import os
import random
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(1, str(ROOT / "scripts"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.analysis import batched_rta as BRTA  # noqa: E402
from repro_torch.benchmarks import bench_executor_vgang as vbench  # noqa: E402
from repro_torch.benchmarks import fig1_parallelization as fig1  # noqa: E402
from repro_torch.benchmarks import fig6_dnn_cdf as fig6  # noqa: E402
from repro_torch.benchmarks import run as bench_run  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.deeppicar import CONFIG as DAVE2  # noqa: E402
from repro_torch.configs.base import ParallelConfig  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenSource  # noqa: E402
from repro_torch.examples import serve_with_background_training as swbt  # noqa: E402
from repro_torch.examples import vgang_fleet  # noqa: E402
from repro_torch.kernels.build import ptxas_report, sass_counts  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.flash_attention.ref import naive_attention  # noqa: E402
from repro_torch.kernels.moe_gmm import ops as gmm  # noqa: E402
from repro_torch.kernels.moe_gmm.ref import (  # noqa: E402
    gmm_reference, gmm_split_reference, gmm_tf32x3_reference)
from repro_torch.kernels.rglru_scan import ops as rg  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import rglru_scan_reference  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_reference  # noqa: E402
from repro_torch.kernels.ssm_glue import ops as glue  # noqa: E402
from repro_torch.launch import serve, sweep  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.launch.sweep import (random_gang_taskset,  # noqa: E402
                                      taskset_seed)
from repro_torch.models import dave2 as DV  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import mamba2 as MB  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import rglru as RG  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.obs.perfetto import (export_trace,  # noqa: E402
                                      segments_from_json,
                                      validate_chrome_trace,
                                      write_chrome_trace)
from repro_torch.roofline import report as RR  # noqa: E402
from repro_torch.roofline.op_analysis import analyze  # noqa: E402
from repro_torch.roofline.work import (ssm_conv_act_work,  # noqa: E402
                                       ssm_gate_norm_work)
from repro_torch.roofline.work import (flash_work, gmm_work,  # noqa: E402
                                       rglru_work, ssd_work)
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from repro_torch.training.optimizer import OptConfig, Optimizer  # noqa: E402
from repro_torch.training.runner import (RunnerConfig,  # noqa: E402
                                         SimulatedFailure, TrainRunner)
from repro_torch.training.step import loss_and_grads  # noqa: E402
from repro_torch.vgang import grid  # noqa: E402
from repro_torch.vgang import rta as VRTA  # noqa: E402
from repro_torch.vgang.grid import (n_tasks_for,  # noqa: E402
                                    random_vgang_taskset)
from repro_torch.vgang.formation import (assign_priorities,  # noqa: E402
                                         intensity_interference,
                                         singleton_vgangs)
from torch_flash_cases import (AUDIO_FRAMES, AUDIO_PROMPTS,  # noqa: E402
                               CP_CASES, SOFTCAP_CASES, TIMED, VLM_PROMPTS,
                               WGMMA_EDGES)
from torch_gmm_cases import (EP_N, SERVE_SHAPES, ep_cases,  # noqa: E402
                             gmm_counts)
import torch_fig1_overlap as fig1_trace  # noqa: E402

# H100 SXM published peaks (dense): bf16 tensor cores, f32 without them,
# HBM3 bandwidth (repro_torch.roofline.report, where their sources stand)
PEAK_OPS = {dt: RR.PEAK_FLOPS[str(dt).removeprefix("torch.")]
            for dt in (torch.bfloat16, torch.float32)}
HBM_BYTES_PER_S = RR.HBM_BW
# f32 products at f32's accuracy on the tensor cores: three TF32 products
# (split TF32) at the card's dense TF32 rate
TF32_OPS_PER_S = 495e12
SPLIT_TF32 = 3
TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
DT_NAME = {torch.float32: "f32", torch.bfloat16: "bf16"}

# (B, Sq, Sk, Hq, Hkv, D, causal, window, dtype): tests/test_kernels.py's
# cases (the serve paths' prefill shapes, TIMED, and the (s) splits are in
# scripts/torch_flash_cases.py)
KERNEL_CASES = [
    (2, 256, 256, 4, 2, 64, True, 0, torch.float32),
    (1, 128, 128, 8, 1, 32, True, 0, torch.float32),
    (2, 256, 256, 4, 4, 64, True, 64, torch.float32),
    (1, 256, 256, 2, 2, 128, False, 0, torch.float32),
    (1, 128, 128, 4, 2, 64, True, 0, torch.bfloat16),
]
VLM_ARCH = "internvl2-1b"
VLM_MAX_SEQ = 2048
AUDIO_ARCH = "whisper-base"
AUDIO_MAX_SEQ = 448
# the edges of the bf16 tensor-core paths (tests/test_torch_flash_attention.
# py's EDGES): S not a multiple of 16 or 64, every head dim, GQA groups 1,
# 4, 7 and 16, one warp's q rows all masked in the first kv tile visited;
# then the wgmma path's (WGMMA_EDGES, scripts/torch_flash_cases.py)
FLASH_EDGES = [(1, 77, 77, 4, 4, 16, True, 0, torch.bfloat16),
               (1, 100, 100, 8, 2, 32, True, 8, torch.bfloat16),
               (2, 129, 129, 14, 2, 64, True, 0, torch.bfloat16),
               (1, 200, 200, 16, 1, 128, True, 16, torch.bfloat16),
               (1, 150, 150, 16, 1, 256, True, 40, torch.bfloat16),
               (1, 65, 65, 4, 4, 128, False, 0, torch.bfloat16),
               (1, 1, 1, 4, 1, 64, True, 0, torch.bfloat16),
               (1, 300, 300, 16, 1, 256, False, 0, torch.bfloat16)] + \
    [(*edge, torch.bfloat16) for edge in WGMMA_EDGES]
REPORTED = (1, 1024, 1024, 28, 4, 128, True, 0, torch.bfloat16)

# moe_gmm: (label, E, C, D, F, counts, dtype); counts as
# scripts/torch_gmm_cases.py's gmm_counts draws them; the serve shapes and
# (t)'s are that module's
GMM_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# the swap path against the plain version of its split over D
# (gmm_split_reference): at most one bf16 ulp, and 1e-4 for sums that cancel
SPLIT_ULP_TOL = {"atol": 1e-4, "rtol": 2 ** -7}
GMM_CASES = [
    ("test", 4, 32, 16, 24, "random", torch.float32),
    ("test", 2, 64, 32, 32, "random", torch.float32),
    ("test", 3, 16, 8, 8, "random", torch.bfloat16),
    ("ragged", 5, 21, 37, 45, "random", torch.float32),
    ("ragged", 3, 70, 50, 130, "random", torch.bfloat16),
]
# the edges of the bf16 tensor-core paths (tests/test_torch_moe_gmm.py's
# EDGES): C of 1, 8, 9 and 160, D and F not multiples of 8 (the fill
# path's 8-row tile at C 1 and 8, its 16-row tile at C 9 and 21), every
# count 0, every count C
GMM_EDGES = [("edge", E, C, D, F, kind, torch.bfloat16)
             for E, C, D, F in ((4, 1, 64, 128), (3, 8, 72, 136),
                                (4, 1, 36, 64), (3, 8, 40, 100),
                                (3, 9, 40, 100), (2, 160, 96, 264),
                                (3, 21, 37, 45))
             for kind in ("random", "zero", "full")]
# the edges of the wgmma path (bf16, C > 16; tests/test_torch_moe_gmm.py's
# WGMMA_EDGES at small widths): C of 17, 63, 64, 65, 128, 192, 300 and
# 2560, E of 1 and 64, D and F multiples of 8 only; counts random, 0, C,
# and every row in one expert
GMM_EDGES += [("wgmma edge", E, C, D, F, kind, torch.bfloat16)
              for E, C, D, F in ((1, 17, 64, 64), (2, 63, 72, 136),
                                 (3, 64, 128, 128), (2, 65, 64, 192),
                                 (64, 128, 72, 136), (3, 192, 256, 512),
                                 (2, 300, 64, 136), (1, 2560, 128, 64))
              for kind in ("random", "zero", "full", "one")]
# the edges of the swap path (bf16, C <= 16, D and F multiples of 8;
# tests/test_torch_moe_gmm.py's SWAP_EDGES at small widths): C of 1, 7,
# 8, 9 and 16, E of 1, 4 and 64, D of 64, 72 and 2048, F of 64 and 136;
# counts random, 0, C, every row in one expert, one row in half of them
GMM_EDGES += [("swap edge", E, C, D, F, kind, torch.bfloat16)
              for E, C, D, F in ((1, 1, 64, 64), (4, 7, 72, 136),
                                 (3, 9, 64, 136), (64, 16, 72, 64),
                                 (64, 8, 64, 136))
              for kind in ("random", "zero", "full", "one", "decode")]
# and olmoe's EP 16 decode shapes, one for each split over D on 132 SMs
# (gmm_splits): 4 experts x 2 tiles of 128 columns (F 256) -> 8 blocks a
# tile, 4 x 8 (gate/up, C 16 and 8) -> 4, 4 x 16 (down) -> 2; 64 x 2 -> 1
GMM_EDGES += [("swap EP edge", E, C, D, F, "random", torch.bfloat16)
              for E, C, D, F in ((4, 16, 2048, 256), (4, 16, 2048, 1024),
                                 (4, 8, 2048, 1024), (4, 16, 1024, 2048),
                                 (64, 8, 512, 256))]
# the edges of the tf32x3 path (f32, D and F multiples of 4;
# tests/test_torch_moe_gmm.py's TF32_EDGES at small widths): C of 1, 7, 9
# and 16 (the decode tiles), 17, 48, 65 (the 64- and 128-row tiles, N
# narrowed to the rows in use), 160 and 2560; E of 1, 4 and 64; D and F
# not multiples of 8; an EP-shaped call at each split over D
GMM_EDGES += [("tf32x3 edge", E, C, D, F, kind, torch.float32)
              for E, C, D, F in ((1, 1, 36, 44), (4, 7, 68, 132),
                                 (2, 9, 4, 4), (64, 16, 36, 12),
                                 (2, 17, 36, 44), (3, 48, 132, 196),
                                 (2, 65, 100, 36), (3, 160, 68, 260),
                                 (1, 2560, 36, 68))
              for kind in ("random", "zero", "full", "one")]
GMM_EDGES += [("tf32x3 EP edge", E, C, D, F, "random", torch.float32)
              for E, C, D, F in ((4, 16, 2048, 256), (4, 16, 2048, 1024),
                                 (4, 8, 2048, 1024), (4, 16, 1024, 2048),
                                 (64, 8, 512, 256))]
GMM_SERVE = [(*shape, dt) for dt in (torch.bfloat16, torch.float32)
             for shape in SERVE_SHAPES]
GMM_REPORTED = GMM_SERVE[0]

# ssd_scan: (label, B, S, H, P, N, chunk, dtype); the first four are
# tests/test_kernels.py's, the serve shapes mamba2-1.3b's prefills
SSD_TOL = 1e-3
SSD_BF16_RTOL = 2.0 ** -8
SSD_CASES = [(label, *shape, dt)
             for dt in (torch.float32, torch.bfloat16)
             for label, shape in (("test", (2, 64, 3, 16, 32, 16)),
                                  ("test", (1, 128, 2, 32, 16, 32)),
                                  ("test", (2, 32, 1, 8, 8, 8)),
                                  ("test", (1, 64, 4, 16, 16, 64)),
                                  ("ragged", (2, 77, 3, 24, 40, 32)),
                                  ("ragged", (1, 300, 2, 40, 128, 256)),
                                  ("chunks", (1, 2048, 64, 64, 128, 256)),
                                  ("chunks", (1, 4096, 64, 64, 128, 256)),
                                  ("batch", (4, 300, 64, 64, 128, 256)),
                                  ("P slice", (2, 600, 8, 40, 128, 256)),
                                  # the 64-row tiles' edges: S under and
                                  # across a tile, P and N not multiples
                                  # of 16, B = 4
                                  ("edge", (1, 1, 4, 64, 128, 256)),
                                  ("edge", (2, 7, 3, 24, 40, 256)),
                                  ("edge", (4, 33, 2, 8, 8, 256)),
                                  ("edge", (1, 65, 5, 40, 128, 256)),
                                  ("edge", (4, 65, 3, 24, 8, 32)),
                                  ("edge", (2, 130, 4, 8, 40, 64)),
                                  ("edge", (2, 150, 4, 24, 40, 256)),
                                  # one chunk of four query tiles (and of
                                  # three above), split over two blocks a
                                  # (b, h)
                                  ("edge", (2, 230, 4, 24, 40, 256)),
                                  # unit-scale inputs, A dt down to -60
                                  ("strong", (2, 300, 3, 24, 40, 256)),
                                  ("strong", (1, 77, 2, 64, 128, 32)))]
SSD_SERVE = [("serve", 1, S, 64, 64, 128, 256, dt)
             for dt in (torch.float32, torch.bfloat16)
             for S in (32, 200, 300, 1024)]
SSD_REPORTED = ("serve", 1, 1024, 64, 64, 128, 256, torch.float32)

# rglru_scan: (label, B, S, C, scale, h0, dtype); the first four are
# tests/test_kernels.py's (scale 8: strong decay), "model" draws log_a and
# gx at recurrentgemma-9b's scale (log_a = -8 softplus(1) r, down to -10.5
# a step), the serve shapes are its prefills (B=1, lru_width 4096)
RG_TOL = 1e-5
RG_BF16_RTOL = 2.0 ** -8
RG_CASES = [(label, *shape, dt)
            for dt in (torch.float32, torch.bfloat16)
            for label, shape in (("test", (2, 64, 16, 2.0, False)),
                                 ("test", (1, 128, 32, 2.0, False)),
                                 ("test", (3, 32, 8, 8.0, False)),
                                 ("test", (1, 256, 16, 8.0, False)),
                                 ("ragged", (2, 77, 45, 2.0, True)),
                                 ("ragged", (1, 300, 130, 2.0, True)),
                                 ("edge", (1, 1, 4096, "model", True)),
                                 ("edge", (1, 7, 4096, "model", False)),
                                 ("edge", (1, 9, 4096, "model", True)),
                                 ("edge", (1, 257, 4096, "model", True)),
                                 ("long", (1, 4096, 4096, "model", False)),
                                 ("edge", (1, 300, 4097, "model", True)),
                                 ("batch", (4, 1024, 4096, "model", True)))]
RG_SERVE = [("serve", 1, S, 4096, "model", False, dt)
            for dt in (torch.float32, torch.bfloat16)
            for S in (32, 200, 300, 1024)]
RG_REPORTED = ("serve", 1, 1024, 4096, "model", False, torch.float32)

# the gang runs of the state-cache families: batch-1 prefills of these
# prompts in the first quantum, then the batched decode step as the RT job
GANG_PROMPTS = (32, 200, 1024, 300)
# (c6) mamba2's prefill glue: (B, S, dtype) at mamba2-1.3b's widths, (d3)'s
# batch-1 prefills in both dtypes and the benchmark's B 8 prompts; timed
# rows also in a CUDA graph, the last one reported
GLUE_CASES = [(1, S, dt) for dt in (torch.float32, torch.bfloat16)
              for S in (32, 200, 1024, 300)] + [(8, 2048, torch.bfloat16)]
GLUE_TIMED = ((1, 1024, torch.float32), (1, 1024, torch.bfloat16),
              (8, 2048, torch.bfloat16))
GLUE_REPORTED = (8, 2048, torch.bfloat16)
UNIT_ROUNDOFF = {torch.bfloat16: 2.0 ** -8, torch.float32: 2.0 ** -24}
GANG_NEW = 16
GANG_ORACLE_NEW = 8
MAMBA_ARCH = "mamba2-1.3b"
HYBRID_ARCH = "recurrentgemma-9b"
HYBRID_MAX_SEQ = 2048

# f32 prefill and decode logits (and caches) through the kernels vs through
# their plain versions, full width and depth: sums taken in another order,
# nothing else
PLAIN_PATH_TOL = 1e-3
PLAIN_PATH_PROMPTS = (32, 20, 45, 9)      # one per slot: 4 decode positions
PLAIN_PATH_STEPS = 4
# decode after a prefill vs a one-token-longer prefill, f32
# (tests/test_models_smoke.py's tolerance)
DECODE_PREFILL_TOL = 2e-3

# DAVE-2 (f): the card vs the CPU in f32 with TF32 off; (h): the Fig.6 run
DAVE2_BATCHES = (1, 8)
DAVE2_TOL = 1e-5
FIG6_DURATION = 6.0
FIG6_TRACED_S = 2.0

# (i): the fleet example's three dispatch modes, 2 s each
FLEET_RUNS = ([], ["--rtg-throttle"], ["--reclaim"])
FLEET_DURATION = 2.0
# (j): the grid's full default shard (vgang/grid.py run_grid): cores x
# width distributions x utilizations x 50 sets, seed 0, gamma 0.5
GRID_CORES = (4, 8, 16)
GRID_DISTS = ("light", "mixed", "heavy")
GRID_UTILS = (0.4, 0.7, 0.9, 1.0, 1.1, 1.2, 1.4, 1.6, 2.0)
GRID_SETS = 50
RTA_RTOL = 1e-12

SERVE_PROMPTS = (32, 200, 1024, 77, 512, 300)
SERVE_MAX_NEW = 16
# (d5) / (d6): the two shipped dense configs that fit one card and no
# earlier phase served. granite-20b is multi-query (48 q heads on one kv
# head); its f32 oracle keeps 4 of its 52 layers (10.9 GB; all 52 would be
# 113 GB). minitron-4b has a 256,000-entry vocabulary.
GRANITE_ARCH = "granite-20b"
GRANITE_ORACLE_LAYERS = 4
MINITRON_ARCH = "minitron-4b"
# (x): the logit softcap through a model on the card: qwen2-7b at full
# width, 4 of its 28 layers, f32, with logit_softcap 1.0
SOFTCAP_MODEL_ARCH = "qwen2-7b"
SOFTCAP_MODEL_LAYERS = 4
SOFTCAP_MODEL_CAP = 1.0
SOFTCAP_MODEL_PROMPT = 300
# (k): qwen2-7b at full width, depth cut 28 -> 8 (18 B a parameter under
# f32 AdamW with bf16 compute: 8 layers 53 GB, 28 layers 137 GB)
TRAIN_ARCH = "qwen2-7b"
TRAIN_LAYERS = 8
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 30
TRAIN_SKIP = 3                          # steps left out of the median
# the f32 card-vs-CPU step: 2 layers, B=1, S=256 (TF32 off)
CHECK_LAYERS, CHECK_SEQ = 2, 256
CHECK_LOSS_RTOL = 1e-5
CHECK_GRAD_TOL = 1e-4                   # of each leaf's largest |g|
ZERO_GRAD_TOL = 1e-6                    # of the tree's largest |g|
# the restart path at reduced size: 12 steps, checkpoints every 4, a
# failure at step 10. cuBLAS and the sorted index_put of the embedding's
# backward repeat their sums on one card, so the losses should agree bit
# for bit; the check allows 1e-5 relative for the order of any atomic add
RESTART_RTOL = 1e-5
# (o): scripts/torch_smoke_one.py for one arch of each family, then the f32
# card-vs-CPU loss + gradient of the two stub-tower families, reduced
SMOKE_ARCHS = ("qwen2-7b", "olmoe-1b-7b", "mamba2-1.3b", "recurrentgemma-9b",
               "internvl2-1b", "whisper-base")
SMOKE_SEQ = 32
# (p): the seeded smoke configs of the grid and the sweep
GRID_SMOKE = ROOT / "configs" / "experiments" / "grid_smoke.json"
SWEEP_SMOKE = ROOT / "configs" / "experiments" / "sweep_smoke.json"
# (r): the reduced configs' prompt and decode cache for the analysis of
# one callable on the card against the CPU
ROOF_SEQ = 24
ROOF_MAX_SEQ = 64
# (l): the example's RT side (qwen2-7b bf16, full depth) beside its BE
# side (olmoe-1b-7b at full width, bf16 compute / f32 masters, depth cut
# 16 -> 4: 34 GB of training state beside the serving gang's 18 GB)
BE_TRAIN_LAYERS = 4
SERVE_TRAIN_DURATION = 6.0
# (l)'s modes: the example's RT-Gang run declares 1e6 B a microstep against
# the gang's 5e5 B budget and so admits none once the gang leads; a second
# RT-Gang run declares half the budget, so that the regulator admits real
# microsteps beside the gang (a declared cost: the cost estimate is A4)
BE_FIT_BYTES = 2.5e5
SERVE_TRAIN_MODES = (("rtgang", True, swbt.TRAIN_BYTES),
                     ("rtgang_fit", True, BE_FIT_BYTES),
                     ("cosched", False, swbt.TRAIN_BYTES))


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Mean device time of one call: ``iters`` calls captured in a CUDA
    graph and replayed ``replays`` times, so no host dispatch is timed (a
    short kernel's time_ms is its wrapper's host time)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def bound(case, q_offset: int = 0, fma: bool = False) -> tuple[float, str]:
    """Least time the card could take: the larger of the operations over
    the peak rate of the input type and the bytes (each input read once,
    the output written once) over the memory rate. f32 products are taken
    at the split-TF32 rate (three TF32 products at 495 TFLOP/s), as the
    tf32x3 path takes them; ``fma``: at the f32 FMA rate (67 TFLOP/s)."""
    ops, nbytes = flash_work(case, q_offset)
    dt = case[-1]
    rate = PEAK_OPS[dt]
    if dt == torch.float32 and not fma:
        rate = TF32_OPS_PER_S / SPLIT_TF32
    t_ops, t_bytes = ops / rate, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def f32_bounds(row: dict, case, q_offset: int = 0) -> str:
    """An f32 row's graph time against both f32 bounds: adds fma_bound_ms,
    share (of the split-TF32 bound, bound_ms) and fma_share; returns the
    text printed beside the row."""
    fma_ms, _ = bound(case, q_offset, fma=True)
    row.update(fma_bound_ms=fma_ms, share=row["bound_ms"] / row["graph_ms"],
               fma_share=fma_ms / row["graph_ms"])
    return (f"split-TF32 bound {row['bound_ms']:.4f} ms "
            f"({100 * row['share']:.1f}%), FMA-rate bound {fma_ms:.4f} ms "
            f"({100 * row['fma_share']:.1f}%)")


def case_name(case) -> str:
    B, Sq, Sk, Hq, Hkv, D, causal, window, dt = case
    S = f"S={Sq}" if Sq == Sk else f"Sq={Sq} Sk={Sk}"
    return (f"B={B} {S} Hq={Hq} Hkv={Hkv} D={D} "
            f"{'causal' if causal else 'full'}"
            f"{f' window={window}' if window else ''} {DT_NAME[dt]}")


def flash_call(q, k, v, **kw) -> tuple[torch.Tensor, str]:
    """One wrapper call, synchronised; its output and the path it took."""
    before = dict(fa.launches_by_path)
    out = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    (path,) = [p for p, n in fa.launches_by_path.items() if n != before[p]]
    return out, path


def check_flash_paths(what: str, total: int, smi: str) -> dict:
    """Flash's launches by path since the last reset, after a bf16 run:
    each of the ``total`` must have taken the wgmma path (no shipped config
    has a head dim below 64)."""
    paths = dict(fa.launches_by_path)
    print(f"[{what}] flash_attention launches by path {paths} (total "
          f"{total}) [{smi}]")
    if paths != {"fma": 0, "tc": 0, "wgmma": total, "tf32x3": 0}:
        fail(f"{what}: flash_attention took {paths}; all {total} bf16 "
             f"launches must take wgmma")
    return paths


def check_f32_flash_paths(what: str, smi: str) -> dict:
    """Flash's launches by path since the last reset, after an f32 run:
    every one must have taken the tf32x3 path (no shipped config has a
    head dim below 64)."""
    paths = dict(fa.launches_by_path)
    print(f"[{what}] flash_attention launches by path {paths} [{smi}]")
    if any(n for p, n in paths.items() if p != "tf32x3"):
        fail(f"{what}: flash_attention took {paths}; every f32 launch at "
             f"D >= 64 must take tf32x3")
    return paths


def check_f32_gmm_paths(what: str, smi: str) -> dict:
    """moe_gmm's launches by path since the last reset, after an f32 run:
    there must be some, and every one must have taken the tf32x3 path (a
    model's f32 calls are all TMA-addressable)."""
    paths = dict(gmm.launches_by_path)
    print(f"[{what}] moe_gmm launches by path {paths} [{smi}]")
    if not paths["tf32x3"] or any(n for p, n in paths.items()
                                  if p != "tf32x3"):
        fail(f"{what}: moe_gmm took {paths}; every f32 launch must take "
             f"tf32x3")
    return paths


def phase_kernel(dev, smi: str) -> list[dict]:
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = []
    for case in KERNEL_CASES + FLASH_EDGES + TIMED:
        B, Sq, Sk, Hq, Hkv, D, causal, window, dt = case
        q = torch.randn((B, Sq, Hq, D), generator=gen, device=dev).to(dt)
        k = torch.randn((B, Sk, Hkv, D), generator=gen, device=dev).to(dt)
        v = torch.randn((B, Sk, Hkv, D), generator=gen, device=dev).to(dt)
        out, path = flash_call(q, k, v, causal=causal, window=window)
        want = fa.flash_path(dt, D, True)
        if path != want:
            fail(f"(c) {case_name(case)} took the {path} path, not {want}")
        ref = naive_attention(q, k, v, causal=causal, window=window)
        err = (out.float() - ref.float()).abs().max().item()
        tol = TOL[dt]
        ok = torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol)
        row = {"case": case_name(case), "path": path, "max_abs_err": err,
               "tol": tol, "ok": bool(ok)}
        if case in TIMED:
            qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            if window:
                i = torch.arange(Sq, device=dev)
                mask = (i[None, :] <= i[:, None]) & \
                    (i[None, :] > i[:, None] - window)
                lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    qh, kh, vh, attn_mask=mask, enable_gqa=True)
            else:
                lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    qh, kh, vh, is_causal=causal, enable_gqa=True)
            bound_ms, bound_by = bound(case)
            call = lambda: fa.flash_attention(  # noqa: E731
                q, k, v, causal=causal, window=window)
            row.update(
                ms=time_ms(call),
                plain_ms=time_ms(lambda: naive_attention(
                    q, k, v, causal=causal, window=window)),
                library_ms=time_ms(lib), bound_ms=bound_ms,
                bound_by=bound_by, reported=case == REPORTED)
            ops, nbytes = flash_work(case)
            row.update(ratio=row["ms"] / row["library_ms"],
                       tflops=ops / row["ms"] / 1e9,
                       tbps=nbytes / row["ms"] / 1e9)
            # device time: kernel and SDPA in a CUDA graph each
            row.update(graph_ms=graph_ms(call), library_graph_ms=graph_ms(lib))
            row.update(share=bound_ms / row["graph_ms"],
                       graph_ratio=row["graph_ms"] / row["library_graph_ms"])
            shares = f"{100 * row['share']:.1f}% of the bound"
            if dt == torch.float32:
                shares = f32_bounds(row, case)
            graph = (f" (graph {row['graph_ms']:.4f} ms against sdpa's "
                     f"{row['library_graph_ms']:.4f}: "
                     f"{row['graph_ratio']:.2f}x, {shares})")
            print(f"[kernel] {row['case']}: {path} path, kernel "
                  f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, sdpa "
                  f"{row['library_ms']:.4f} ms, kernel/sdpa "
                  f"{row['ratio']:.2f}x, {row['tflops']:.1f} TFLOP/s, "
                  f"{row['tbps']:.3f} TB/s, bound {bound_ms:.4f} ms "
                  f"({bound_by}){graph}, max_abs_err {err:.3g} [{smi}]")
        else:
            print(f"[kernel] {row['case']}: {path} path, max_abs_err "
                  f"{err:.3g}")
        if not ok:
            fail(f"flash_attention disagrees with its plain version on "
                 f"{row['case']}: max_abs_err {err} > {tol}")
        rows.append(row)
    return rows


# (c5)'s inputs in bf16: q and k scaled so that the scaled scores have a
# standard deviation of SCORE_STD[cap] (at softcap 1 and at 50 the cap
# bends the largest scores), V at V_STD, so that each way of applying the
# cap wrongly (mis_capped) moves the output by many times TOL; f32's TOL is
# 1500 times finer, and N(0, 1) inputs already do that there
SCORE_STD = {1.0: 1.0, 50.0: 3.0}
V_STD = 8.0


def mis_capped(q, k, v, cap: float, **kw) -> dict:
    """The plain version with the cap applied wrongly, in f32, each a way a
    kernel could get it wrong, from the raw score r = q k^T, the scale
    1/sqrt(D) and the right cap c tanh(r scale / c); naive_attention caps
    c' tanh(r' scale / c') of r' = (a q) k^T, so a and c' pick each."""
    sc = q.shape[-1] ** -0.5
    q, k, v = q.float(), k.float(), v.float()
    out = {"no cap": naive_attention(q, k, v, **kw),
           # scale c tanh(r / c): the cap before the scale
           "cap on the unscaled score": naive_attention(
               q, k, v, softcap=cap * sc, **kw),
           # scale c tanh(r scale / c): m in the wrong units
           "capped score scaled again": naive_attention(
               q * sc, k, v, softcap=cap * sc, **kw)}
    if cap != 1.0:   # c tanh(r scale) is the right cap at c = 1
        out["c tanh(s)"] = naive_attention(q * cap, k, v, softcap=cap, **kw)
    return out


def flex_softcap(q, k, v, cap: float, *, causal: bool, window: int,
                 q_offset: int):
    """library_ms's call for a softcapped case: PyTorch's FlexAttention,
    compiled by torch.compile, with the cap as its score_mod and the causal
    / window / q_offset mask as its block mask (timed only; the port never
    calls it). Returns (call, how): how is "compiled", or "eager" with the
    reason where the compile failed."""
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    c = torch.tensor(cap, device=q.device)

    def score_mod(s, b, h, i, j):
        return c * torch.tanh(s / c)

    def mask_mod(b, h, i, j):
        ok = j >= 0
        if causal:
            ok = ok & (j <= i + q_offset)
        if window:
            ok = ok & (j > i + q_offset - window)
        return ok

    block_mask = None
    if causal or window:
        block_mask = create_block_mask(mask_mod, None, None, q.shape[1],
                                       k.shape[1], device=q.device)
    torch._dynamo.reset()    # one compile a case, under the recompile limit
    compiled = torch.compile(flex_attention, dynamic=False)

    def call(fn):
        return lambda: fn(qh, kh, vh, score_mod=score_mod,  # noqa: E731
                          block_mask=block_mask, enable_gqa=True)
    try:
        call(compiled)()
        torch.cuda.synchronize()
        return call(compiled), "compiled"
    except Exception as e:   # noqa: BLE001 (the reason goes in the row)
        return call(flex_attention), f"eager ({type(e).__name__}: {e})"[:200]


def phase_softcap(dev, smi: str) -> list[dict]:
    """(c5): the flash kernel with a logit softcap against its plain version
    on SOFTCAP_CASES at TOL, one launch a call; every mis_capped version
    must differ from the kernel by more than TOL. Kernel, plain version and
    FlexAttention with the cap (compiled) timed beside the bound (the cap
    adds no charged work)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    rows = []
    for case, off, cap in SOFTCAP_CASES:
        B, Sq, Sk, Hq, Hkv, D, causal, window, dt = case
        bf16 = dt == torch.bfloat16
        qk_std = SCORE_STD[cap] ** 0.5 if bf16 else 1.0
        q = (torch.randn((B, Sq, Hq, D), generator=gen, device=dev)
             * qk_std).to(dt)
        k = (torch.randn((B, Sk, Hkv, D), generator=gen, device=dev)
             * qk_std).to(dt)
        v = (torch.randn((B, Sk, Hkv, D), generator=gen, device=dev)
             * (V_STD if bf16 else 1.0)).to(dt)
        kw = dict(causal=causal, window=window, q_offset=off)
        before = fa.launches
        out = fa.flash_attention(q, k, v, softcap=cap, **kw)
        torch.cuda.synchronize()
        if fa.launches != before + 1:
            fail(f"(c5) flash launched {fa.launches - before} times on one "
                 f"call")
        out = out.float()
        ref = naive_attention(q, k, v, softcap=cap, **kw).float()
        err = (out - ref).abs().max().item()
        tol = TOL[dt]
        name = f"{case_name(case)} q_offset={off} softcap={cap}"
        if not torch.allclose(out, ref, atol=tol, rtol=tol):
            fail(f"flash_attention with a softcap disagrees with its plain "
                 f"version on {name}: max_abs_err {err} > {tol}")
        # max |out - x| / (tol + tol |x|): above 1, allclose fails
        margin = {w: ((out - x).abs() / (tol + tol * x.abs())).max().item()
                  for w, x in mis_capped(q, k, v, cap, **kw).items()}
        for w, m in margin.items():
            if m <= 1.0:
                fail(f"(c5) {name}: the kernel is within TOL of the plain "
                     f"version with {w} (margin {m:.3g})")
        flex, how = flex_softcap(q, k, v, cap, **kw)
        lib_err = (flex().transpose(1, 2).float() - ref).abs().max().item()
        bound_ms, bound_by = bound(case, off)
        call = lambda: fa.flash_attention(  # noqa: E731
            q, k, v, softcap=cap, **kw)
        row = {"case": name, "softcap": cap, "q_offset": off,
               "max_abs_err": err, "tol": tol, "ok": True,
               "mis_cap_margin": margin, "ms": time_ms(call),
               "plain_ms": time_ms(lambda: naive_attention(
                   q, k, v, softcap=cap, **kw)),
               "library_ms": time_ms(flex), "library": f"flex_attention {how}",
               "library_max_abs_err": lib_err, "bound_ms": bound_ms,
               "bound_by": bound_by}
        graph = ""
        if not bf16:   # device time: kernel and FlexAttention in graphs
            row["graph_ms"] = graph_ms(call)
            try:
                row["library_graph_ms"] = graph_ms(flex)
                lib_graph = f"{row['library_graph_ms']:.4f} ms"
            except Exception as e:   # noqa: BLE001 (reported in the row)
                row["library_graph_ms"] = None
                lib_graph = f"not captured ({type(e).__name__}: {e})"[:160]
            graph = (f", graph: kernel {row['graph_ms']:.4f} ms, "
                     f"flex_attention {lib_graph}, "
                     f"{f32_bounds(row, case, off)}")
        print(f"[softcap] {name}: kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, flex_attention ({how}) "
              f"{row['library_ms']:.4f} ms (max_abs_err {lib_err:.3g}), "
              f"bound {bound_ms:.4f} ms ({bound_by}){graph}, max_abs_err "
              f"{err:.3g}, "
              f"margin over TOL of the mis-capped versions " + ", ".join(
                  f"{w} {m:.3g}" for w, m in margin.items()) + f" [{smi}]")
        rows.append(row)
    return rows


def gmm_bound(E, C, D, F, counts, dt, fma: bool = False
              ) -> tuple[float, str]:
    """Least time for this call: its operations over the peak rate of the
    type against its bytes over the memory rate (gmm_work). f32 products
    are taken at the split-TF32 rate (three TF32 products at 495 TFLOP/s),
    as the tf32x3 path takes them; ``fma``: at the f32 FMA rate (67
    TFLOP/s)."""
    ops, nbytes = gmm_work(E, C, D, F, counts, dt)
    rate = PEAK_OPS[dt]
    if dt == torch.float32 and not fma:
        rate = TF32_OPS_PER_S / SPLIT_TF32
    t_ops, t_bytes = ops / rate, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def gmm_call(x, w, counts) -> tuple[torch.Tensor, str]:
    """One wrapper call, synchronised; its output and the path it took."""
    before = dict(gmm.launches_by_path)
    out = gmm.grouped_matmul(x, w, counts)
    torch.cuda.synchronize()
    (path,) = [p for p, n in gmm.launches_by_path.items() if n != before[p]]
    return out, path


def gmm_times(x, w, counts) -> dict:
    """The kernel's time back to back (``ms``, the wrapper's host dispatch
    included) and in a CUDA graph (device time), the plain version's,
    ``torch.bmm``'s both ways, the bound and the graph time's share of it.
    """
    E, C, D = x.shape
    bound_ms, bound_by = gmm_bound(E, C, D, w.shape[2], counts, x.dtype)
    call = lambda: gmm.grouped_matmul(x, w, counts)  # noqa: E731
    lib = lambda: torch.bmm(x, w)  # noqa: E731
    row = {"ms": time_ms(call), "graph_ms": graph_ms(call),
           "plain_ms": time_ms(lambda: gmm_reference(x, w, counts)),
           "library_ms": time_ms(lib), "library_graph_ms": graph_ms(lib),
           "bound_ms": bound_ms, "bound_by": bound_by}
    row.update(share=bound_ms / row["graph_ms"],
               graph_ratio=row["graph_ms"] / row["library_graph_ms"])
    if x.dtype == torch.float32:
        fma_ms, _ = gmm_bound(E, C, D, w.shape[2], counts, x.dtype, fma=True)
        row.update(fma_bound_ms=fma_ms, fma_share=fma_ms / row["graph_ms"])
    return row


def gmm_f32_bounds(row: dict) -> str:
    """An f32 row's graph time against both f32 bounds, as printed."""
    return (f"split-TF32 bound {row['bound_ms']:.4f} ms "
            f"({100 * row['share']:.1f}%), FMA-rate bound "
            f"{row['fma_bound_ms']:.4f} ms ({100 * row['fma_share']:.1f}%)")


def phase_gmm(dev, smi: str) -> list[dict]:
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    rows = []
    for case in GMM_CASES + GMM_EDGES + GMM_SERVE:
        label, E, C, D, F, kind, dt = case
        x = torch.randn((E, C, D), generator=gen, device=dev).to(dt)
        w = (torch.randn((E, D, F), generator=gen, device=dev)
             * D ** -0.5).to(dt)
        counts = gmm_counts(kind, E, C, gen, dev)
        out, path = gmm_call(x, w, counts)
        ref = gmm_reference(x, w, counts)
        err = (out.float() - ref.float()).abs().max().item()
        tol = GMM_TOL[dt]
        ok = torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol)
        split_path = path in ("swap", "tf32x3")
        splits = gmm.gmm_splits(E, C, D, F, sms) if split_path else 1
        name = (f"{label} E={E} C={C} D={D} F={F} {DT_NAME[dt]} "
                f"rows in use {int(counts.sum())}, experts in use "
                f"{int((counts > 0).sum())}"
                f"{f', splits {splits}' if split_path else ''}")
        want = gmm.gmm_path(dt, C, D, F, all(
            t.data_ptr() % 16 == 0 for t in (x, w, out)))
        if path != want:
            fail(f"moe_gmm took the {path} path on {name}, not {want}")
        unused = torch.arange(C, device=dev)[None, :, None] >= \
            counts[:, None, None]
        if torch.where(unused, out.float(), 0.0).abs().max().item() != 0.0:
            fail(f"moe_gmm left a nonzero row past counts on {name}")
        split_err = None
        if split_path:
            if not torch.equal(out, gmm_call(x, w, counts)[0]):
                fail(f"moe_gmm's {path} path differs between two calls on "
                     f"{name}")
        if path == "swap":
            split_ref = gmm_split_reference(x, w, counts, splits).float()
            split_err = (out.float() - split_ref).abs().max().item()
            if not torch.allclose(out.float(), split_ref, **SPLIT_ULP_TOL):
                fail(f"moe_gmm's swap path is more than one bf16 ulp from "
                     f"the plain version of its split on {name} (max abs "
                     f"err {split_err:.3g})")
        if path == "tf32x3":
            own = gmm_tf32x3_reference(x, w, counts, splits)
            split_err = (out - own).abs().max().item()
            if not torch.allclose(out, own, atol=tol, rtol=tol):
                fail(f"moe_gmm's tf32x3 path is more than {tol} from the "
                     f"plain version of its arithmetic on {name} (max abs "
                     f"err {split_err:.3g})")
        row = {"case": name, "path": path, "max_abs_err": err, "tol": tol,
               "ok": bool(ok), "splits": splits, "split_err": split_err}
        if case in GMM_SERVE:
            row.update(gmm_times(x, w, counts), reported=case == GMM_REPORTED)
            ops, nbytes = gmm_work(E, C, D, F, counts, dt)
            row.update(ratio=row["ms"] / row["library_ms"],
                       tflops=ops / row["ms"] / 1e9,
                       tbps=nbytes / row["ms"] / 1e9)
            print(f"[gmm] {name}: {path} path, kernel {row['ms']:.4f} ms "
                  f"(graph {row['graph_ms']:.4f} ms), plain "
                  f"{row['plain_ms']:.4f} ms, bmm {row['library_ms']:.4f} "
                  f"ms (graph {row['library_graph_ms']:.4f} ms), "
                  f"kernel/bmm {row['ratio']:.2f}x (graph "
                  f"{row['graph_ratio']:.2f}x), {row['tflops']:.1f} TFLOP/s, "
                  f"{row['tbps']:.3f} TB/s, " + (
                      gmm_f32_bounds(row) + " in the graph"
                      if dt == torch.float32 else
                      f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
                      f"{100 * row['share']:.1f}% of it in the graph")
                  + f", max_abs_err {err:.3g} [{smi}]")
        else:
            print(f"[gmm] {name}: {path} path, max_abs_err {err:.3g}")
        if not ok:
            fail(f"moe_gmm disagrees with its plain version on {name}: "
                 f"max_abs_err {err} > {tol}")
        rows.append(row)
    return rows


def cp_mask(Sq: int, Sk: int, q_offset: int, window: int, dev):
    """The (Sq, Sk) boolean mask of query row i at key position q_offset
    + i: SDPA's bottom-right-aligned causal mask, cut by the window."""
    i = q_offset + torch.arange(Sq, device=dev)[:, None]
    j = torch.arange(Sk, device=dev)[None, :]
    mask = j <= i
    if window:
        mask &= j > i - window
    return mask


def phase_cp(dev, smi: str) -> dict:
    """(s): each rank's flash call on its query rows against the full K/V
    with q_offset = r S / n, f32 and bf16, held against the plain version
    and, concatenated, against the unsplit call; exactly n launches a
    split. Times each rank (CUDA events, mean of 20 calls) beside its
    bound (flash_work with the offset) and SDPA over the first q_offset +
    S / n keys with the bottom-right mask."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    rows, launched = [], 0
    for arch, Hq, Hkv, D, S, n, window in CP_CASES:
        for dt in (torch.bfloat16, torch.float32):
            q = torch.randn((1, S, Hq, D), generator=gen, device=dev).to(dt)
            k = torch.randn((1, S, Hkv, D), generator=gen, device=dev).to(dt)
            v = torch.randn((1, S, Hkv, D), generator=gen, device=dev).to(dt)
            whole = fa.flash_attention(q, k, v, causal=True, window=window)
            whole_ms = time_ms(lambda: fa.flash_attention(
                q, k, v, causal=True, window=window))
            s_loc = S // n
            parts = [q[:, r * s_loc:(r + 1) * s_loc].contiguous()
                     for r in range(n)]
            before = fa.launches
            outs = [fa.flash_attention(parts[r], k, v, causal=True,
                                       window=window, q_offset=r * s_loc)
                    for r in range(n)]
            torch.cuda.synchronize()
            if fa.launches - before != n:
                fail(f"(s) {arch} n={n}: {fa.launches - before} launches "
                     f"for {n} ranks")
            launched += n
            name = (f"{arch} S={S} n={n} Hq={Hq} Hkv={Hkv} D={D}"
                    f"{f' window={window}' if window else ''} {DT_NAME[dt]}")
            tol = TOL[dt]
            ranks = []
            for r in range(n):
                off = r * s_loc
                ref = naive_attention(parts[r], k, v, causal=True,
                                      window=window, q_offset=off)
                err = (outs[r].float() - ref.float()).abs().max().item()
                if not torch.allclose(outs[r].float(), ref.float(),
                                      atol=tol, rtol=tol):
                    fail(f"(s) {name} rank {r}: max_abs_err {err} > {tol}")
                case = (1, s_loc, S, Hq, Hkv, D, True, window, dt)
                ops, nbytes = flash_work(case, off)
                t_ops = ops / (PEAK_OPS[dt] if dt == torch.bfloat16 else
                               TF32_OPS_PER_S / SPLIT_TF32)
                t_bytes = nbytes / HBM_BYTES_PER_S
                qh = parts[r].transpose(1, 2).contiguous()
                kh = k[:, :off + s_loc].transpose(1, 2).contiguous()
                vh = v[:, :off + s_loc].transpose(1, 2).contiguous()
                mask = cp_mask(s_loc, off + s_loc, off, window, dev)
                call = lambda: fa.flash_attention(  # noqa: E731
                    parts[r], k, v, causal=True, window=window, q_offset=off)
                lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    qh, kh, vh, attn_mask=mask, enable_gqa=True)
                ranks.append({
                    "rank": r, "q_offset": off, "max_abs_err": err,
                    "ms": time_ms(call),
                    "plain_ms": time_ms(lambda: naive_attention(
                        parts[r], k, v, causal=True, window=window,
                        q_offset=off), iters=3, warmup=1),
                    "library_ms": time_ms(lib),
                    "bound_ms": max(t_ops, t_bytes) * 1e3,
                    "bound_by": "operations" if t_ops >= t_bytes
                    else "bytes"})
                if dt == torch.float32:   # device time in CUDA graphs
                    ranks[-1].update(graph_ms=graph_ms(call),
                                     library_graph_ms=graph_ms(lib))
                    ranks[-1]["graph"] = (
                        f", graph: kernel {ranks[-1]['graph_ms']:.4f} ms, "
                        f"sdpa {ranks[-1]['library_graph_ms']:.4f} ms, "
                        f"{f32_bounds(ranks[-1], case, off)}")
            cat = torch.cat(outs, dim=1)
            err_cat = (cat.float() - whole.float()).abs().max().item()
            if not torch.allclose(cat.float(), whole.float(), atol=tol,
                                  rtol=tol):
                fail(f"(s) {name}: ranks concatenated differ from the "
                     f"unsplit call by {err_cat} > {tol}")
            slow = max(ranks, key=lambda x: x["ms"])
            for x in ranks:
                print(f"[cp] {name} rank {x['rank']} q_offset "
                      f"{x['q_offset']}: kernel {x['ms']:.4f} ms, sdpa "
                      f"{x['library_ms']:.4f} ms, plain {x['plain_ms']:.4f} "
                      f"ms, bound {x['bound_ms']:.4f} ms ({x['bound_by']})"
                      f"{x.get('graph', '')}, max_abs_err "
                      f"{x['max_abs_err']:.3g}")
            print(f"[cp] {name}: slowest rank {slow['rank']} "
                  f"{slow['ms']:.4f} ms against the unsplit call "
                  f"{whole_ms:.4f} ms ({slow['ms'] / whole_ms:.3f}x), "
                  f"concatenation vs unsplit max_abs_err {err_cat:.3g}, "
                  f"{n} launches [{smi}]")
            rows.append({"case": name, "ranks": ranks,
                         "unsplit_ms": whole_ms, "slowest_ms": slow["ms"],
                         "concat_err": err_cat})
    return {"rows": rows, "launches": launched}


def phase_ep(dev, smi: str) -> dict:
    """(t): moe_gmm against its plain version at the EP bodies' shapes,
    both products of the SwiGLU (D -> F and F -> D), every row counted as
    the bodies count them; f32 and bf16."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    rows, launched = [], 0
    for label, e, C, D, Fd in ep_cases():
        for dt in (torch.bfloat16, torch.float32):
            for din, dout in ((D, Fd), (Fd, D)):
                x = torch.randn((e, C, din), generator=gen,
                                device=dev).to(dt)
                w = (torch.randn((e, din, dout), generator=gen, device=dev)
                     * din ** -0.5).to(dt)
                counts = torch.full((e,), C, dtype=torch.int32, device=dev)
                before = gmm.launches
                out, path = gmm_call(x, w, counts)
                launched += gmm.launches - before
                want = gmm.gmm_path(dt, C, din, dout, True)
                if path != want:
                    fail(f"(t) moe_gmm took the {path} path at E_loc={e} "
                         f"C={C} D={din} F={dout} {DT_NAME[dt]}, not {want}")
                ref = gmm_reference(x, w, counts)
                err = (out.float() - ref.float()).abs().max().item()
                tol = GMM_TOL[dt]
                name = (f"olmoe EP{EP_N} {label} E_loc={e} C={C} "
                        f"D={din} F={dout} {DT_NAME[dt]}")
                if not torch.allclose(out.float(), ref.float(), atol=tol,
                                      rtol=tol):
                    fail(f"(t) {name}: max_abs_err {err} > {tol}")
                row = {"case": name, "path": path, "max_abs_err": err,
                       **gmm_times(x, w, counts)}
                print(f"[ep] {name}: {path} path, kernel {row['ms']:.4f} ms "
                      f"(graph {row['graph_ms']:.4f} ms), plain "
                      f"{row['plain_ms']:.4f} ms, bmm "
                      f"{row['library_ms']:.4f} ms (graph "
                      f"{row['library_graph_ms']:.4f} ms), " + (
                          gmm_f32_bounds(row) + " in the graph"
                          if dt == torch.float32 else
                          f"bound {row['bound_ms']:.4f} ms "
                          f"({row['bound_by']}), {100 * row['share']:.1f}% "
                          f"of it in the graph")
                      + f", max_abs_err {err:.3g} [{smi}]")
                rows.append(row)
    return {"rows": rows, "launches": launched}


# (u): dry-run cells, one process each (a fake-backend group is process-
# global): the cp recipe (qwen2-7b: 28 heads over 16), tp attention with
# FSDP and expert parallelism (olmoe-1b-7b train: the all-to-all; decode:
# the replicated experts), the multi-pod mesh (kimi-k2), the Mamba2 scan
# under shard_map, a batch of 1 (recurrentgemma-9b long_500k) and
# whisper's 8 heads over 16 in training; qwen2-72b train_4k (tp, FSDP)
# traces for ~130 s and is left to the sweep
DRYRUN_CELLS = [("qwen2-7b", "train_4k", False),
                ("qwen2-7b", "prefill_32k", False),
                ("qwen2-7b", "decode_32k", False),
                ("olmoe-1b-7b", "train_4k", False),
                ("olmoe-1b-7b", "decode_32k", False),
                ("kimi-k2-1t-a32b", "decode_32k", True),
                ("mamba2-1.3b", "prefill_32k", False),
                ("recurrentgemma-9b", "long_500k", False),
                ("whisper-base", "train_4k", False)]
DRYRUN_KEYS = ("arch", "shape", "mesh", "variant", "recipe", "n_params",
               "n_active_params", "chips", "tokens", "dtype", "lower_s",
               "flops_per_device", "bytes_per_device",
               "bytes_inner_loops_per_device", "collectives_per_device",
               "memory")


def phase_dryrun(smi: str) -> dict:
    """(u): each cell of DRYRUN_CELLS traced by ``launch.dryrun`` in its
    own process, all at once; fails on a missing key, on a cell of a
    multi-device mesh with no collective, or on a train cell whose
    FLOPs per device are more than 2x from 8 N_active tokens / chips (N
    without the input table; forward, backward and the forward again of
    remat "block"). Prints the roofline bench's table of the cells."""
    from repro_torch.benchmarks import roofline_bench
    from repro_torch.launch import dryrun
    with ThreadPoolExecutor(len(DRYRUN_CELLS)) as pool:
        cells = list(pool.map(
            lambda c: dryrun.run_cell_subprocess(*c, timeout=600),
            DRYRUN_CELLS))
    rows = []
    for cell in cells:
        name = f"{cell['arch']} {cell['shape']} {cell['mesh']}"
        missing = [k for k in DRYRUN_KEYS if k not in cell]
        if missing:
            fail(f"(u) {name}: missing keys {missing}")
        n_coll = sum(cell["collectives_per_device"]["counts"].values())
        if cell["chips"] > 1 and not n_coll:
            fail(f"(u) {name}: no collective on {cell['chips']} devices")
        row = {"cell": name, "recipe": cell["recipe"],
               "flops_per_device": cell["flops_per_device"],
               "collectives": n_coll, "lower_s": cell["lower_s"]}
        if cell["shape"].startswith("train"):
            cfg = get_config(cell["arch"])
            n = cell["n_active_params"] - cfg.vocab_size * cfg.d_model
            want = 8 * n * cell["tokens"] / cell["chips"]
            row["model_flops_8n"] = want
            ratio = cell["flops_per_device"] / want
            if not 0.5 <= ratio <= 2.0:
                fail(f"(u) {name}: {cell['flops_per_device']:.4g} FLOPs a "
                     f"device, {ratio:.3f}x of 8 N tokens / chips "
                     f"{want:.4g}")
            row["ratio_to_8n"] = ratio
        print(f"[dryrun] {name} ({cell['recipe']}): "
              f"{cell['flops_per_device']:.6g} FLOPs, "
              f"{cell['bytes_per_device']:.6g} B, collectives "
              f"{cell['collectives_per_device']['counts']}, temp "
              f"{cell['memory']['temp_size_bytes']} B, traced in "
              f"{cell['lower_s']} s"
              + (f", {row['ratio_to_8n']:.3f}x of 8 N tokens / chips"
                 if "ratio_to_8n" in row else ""))
        rows.append(row)
    table = roofline_bench.run()
    print(RR.markdown_table(table))
    print(f"[dryrun] the roofline terms are the H100 model's "
          f"(repro_torch.roofline.report), not times on [{smi}]")
    return {"cells": rows, "roofline": table}


# (v): the models on a one-rank DeviceMesh, every leaf a DTensor; one
# prompt a model at full width and depth, f32; the launches a prefill
MESH_PROMPT = 200
MESH_EXPECT = {MAMBA_ARCH: {"ssd_scan": 48},
               HYBRID_ARCH: {"rglru_scan": 26, "flash_attention": 12}}
MESH_TOL = {MAMBA_ARCH: SSD_TOL, HYBRID_ARCH: RG_TOL}


def phase_mesh(dev, smi: str) -> dict:
    """(v): see the module docstring. Fails if a leaf of the mesh model is
    not a DTensor, on a launch count, on an output beyond tolerance, or
    on a checkpoint leaf that is not the saved one bit for bit."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from repro_torch.checkpoint.ckpt import CheckpointManager
    from repro_torch.training.step import make_train_state, make_train_step
    work = ROOT / "build" / "mesh_v"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    dist.init_process_group("nccl", init_method=f"file://{work}/rdzv",
                            rank=0, world_size=1)
    out = {"launches": {k: 0 for k in KERNELS}, "models": {}}
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        par = ParallelConfig(param_dtype="float32", compute_dtype="float32")
        for arch, expect in MESH_EXPECT.items():
            cfg = get_config(arch)
            plain = build_model(cfg, par, dev)
            params = plain.init(seed=7)
            api = build_model(cfg, par, dev, mesh=mesh, sharded=True)
            placed = api.load(params)
            if not all(isinstance(a, DTensor) for a in L.tree_leaves(placed)):
                fail(f"(v) {arch}: a leaf of the mesh model is no DTensor")
            gen = torch.Generator(device=dev).manual_seed(11)
            tokens = torch.randint(0, cfg.vocab_size, (1, MESH_PROMPT),
                                   generator=gen, device=dev)
            want_logits, want = plain.prefill_fn(params, {"tokens": tokens})
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            logits, caches = api.prefill_fn(placed, {"tokens": tokens})
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            got = read_launches()
            want_l = {k: expect.get(k, 0) for k in KERNELS}
            if got != want_l:
                fail(f"(v) {arch}: launches {got}, expected {want_l}")
            check_f32_flash_paths(f"(v) {arch} on the mesh", smi)
            for k in KERNELS:
                out["launches"][k] += got[k]
            if not isinstance(logits, DTensor):
                fail(f"(v) {arch}: the mesh prefill returned no DTensor")
            errs = {"logits": (logits.full_tensor() - want_logits)
                    .abs().max().item()}
            for (path, a), (_, b) in zip(leaves(caches), leaves(want)):
                a = a.full_tensor() if isinstance(a, DTensor) else a
                errs[path] = (a.float() - b.float()).abs().max().item()
            tol = MESH_TOL[arch]
            bad = {k: e for k, e in errs.items() if not e <= tol}
            if bad:
                fail(f"(v) {arch}: mesh vs one device beyond {tol}: {bad}")
            worst = max(errs.values())
            print(f"[mesh] {arch}: prefill of {MESH_PROMPT} tokens on a "
                  f"(1, 1) DeviceMesh, every leaf a DTensor: launches "
                  f"{got}, max |mesh - one device| {worst:.3g} over logits "
                  f"and {len(errs) - 1} cache leaves (atol {tol}), "
                  f"{ms:.1f} ms [{smi}]")
            out["models"][arch] = {"launches": got, "max_abs_err": worst,
                                   "errs": errs, "ms": ms}
            del plain, params, api, placed, caches, want, logits
            gc.collect()
            torch.cuda.empty_cache()
        # the mesh-aware checkpoint: a reduced training state, one step in
        cfg = reduced(get_config(HYBRID_ARCH), n_layers=5)
        opt = Optimizer(OptConfig(name="adamw", lr=1e-2, warmup=0,
                                  state_dtype="bfloat16"))
        api = build_model(cfg, par, dev, mesh=mesh, sharded=True)
        state = make_train_state(api, opt, seed=3)
        src = TokenSource(DataConfig(seq_len=32, global_batch=4,
                                     vocab_size=cfg.vocab_size))
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in src.train_batch(0).items()}
        state, _ = make_train_step(api, opt)(state, batch)
        ckpt = CheckpointManager(str(work / "ckpt"))
        ckpt.save(state, 1, blocking=True)

        def bits(t):
            t = (t.full_tensor() if isinstance(t, DTensor) else t).detach()
            return t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        saved = {p: bits(t) for p, t in leaves(state)}
        n_bf16 = sum(t.dtype == torch.int16 for t in saved.values())
        for where, like_api in (("mesh", api),
                                ("one device", build_model(cfg, par, dev))):
            like = make_train_state(like_api, opt, seed=9)
            got, _ = ckpt.restore(like)
            for (path, g), (_, w) in zip(leaves(got), leaves(like)):
                if isinstance(w, DTensor) != isinstance(g, DTensor) or (
                        isinstance(w, DTensor) and
                        tuple(g.placements) != tuple(w.placements)):
                    fail(f"(v) checkpoint onto {where}: {path} not placed "
                         f"as the tree it restored like")
                if not torch.equal(bits(g), saved[path]):
                    fail(f"(v) checkpoint onto {where}: {path} differs")
        out["checkpoint"] = {"leaves": len(saved), "bf16_leaves": n_bf16}
        print(f"[mesh] checkpoint of the reduced {HYBRID_ARCH} training "
              f"state from the (1, 1) mesh: {len(saved)} leaves "
              f"({n_bf16} bf16) restored onto the mesh and onto one device "
              f"bit for bit")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(work, ignore_errors=True)
    return out


def ssd_inputs(B, S, H, P, N, dt, gen, dev, strong: bool = False):
    """Inputs at mamba2's scale: x, B and C are silu of the causal conv's
    output (std 0.5 under the model's init), dt is softplus of a unit
    normal (dt_bias 0), A = -exp(A_log) with A_log uniform in [0, log 16]
    (from -1, the init, to -16). ``strong``: as tests/test_torch_ssd_scan.py
    draws its strong decay: unit normal x, B, C, dt = 2 |N|, A = -16
    (|N| + 0.1), so exp(Lc) and the decays underflow inside a chunk."""
    if strong:
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev)
        return (randn(B, S, H, P).to(dt), (2.0 * randn(B, S, H).abs()).to(dt),
                randn(B, S, N).to(dt), randn(B, S, N).to(dt),
                -16.0 * (randn(H).abs() + 0.1))

    def act(shape):
        return F.silu(0.5 * torch.randn(shape, generator=gen, device=dev))
    x = act((B, S, H, P)).to(dt)
    dtv = F.softplus(torch.randn((B, S, H), generator=gen,
                                 device=dev)).to(dt)
    Bm, Cm = act((B, S, N)).to(dt), act((B, S, N)).to(dt)
    A = -torch.exp(torch.rand((H,), generator=gen, device=dev)
                   * float(np.log(16.0)))
    return x, dtv, Bm, Cm, A


def ssd_bound(B, S, H, P, N, chunk, dt,
              fma: bool = False) -> tuple[float, str]:
    """Least time for this call: ssd_work's operations over the peak rate
    against its bytes over the memory rate. f32 products are taken at the
    split-TF32 rate (three TF32 products at 495 TFLOP/s), as the kernel
    takes them on the tensor cores; ``fma``: at the f32 FMA rate (67
    TFLOP/s), the bound of the earlier FMA kernels. bf16 at 989 TFLOP/s."""
    ops, nbytes = ssd_work(B, S, H, P, N, chunk, dt)
    rate = PEAK_OPS[dt]
    if dt == torch.float32 and not fma:
        rate = TF32_OPS_PER_S / SPLIT_TF32
    t_ops, t_bytes = ops / rate, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def phase_ssd(dev, smi: str) -> list[dict]:
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    rows = []
    for case in SSD_CASES + SSD_SERVE:
        label, B, S, H, P, N, chunk, dt = case
        args = ssd_inputs(B, S, H, P, N, dt, gen, dev,
                          strong=label == "strong")
        y, h = ssd.ssd_scan(*args, chunk=chunk)
        torch.cuda.synchronize()
        yr, hr = ssd_chunked_reference(*args, chunk=chunk)
        rtol = SSD_BF16_RTOL if dt == torch.bfloat16 else 0.0
        err = max((y.float() - yr).abs().max().item(),
                  (h - hr).abs().max().item())
        ok = (y.dtype == dt and h.dtype == torch.float32 and
              torch.allclose(y.float(), yr, atol=SSD_TOL, rtol=rtol) and
              torch.allclose(h, hr, atol=SSD_TOL, rtol=0.0))
        name = (f"{label} B={B} S={S} H={H} P={P} N={N} chunk={chunk} "
                f"{DT_NAME[dt]}")
        row = {"case": name, "max_abs_err": err, "tol": SSD_TOL,
               "rtol": rtol, "ok": bool(ok)}
        if case in SSD_SERVE:
            bound_ms, bound_by = ssd_bound(B, S, H, P, N, chunk, dt)
            fma_ms, _ = ssd_bound(B, S, H, P, N, chunk, dt, fma=True)
            row.update(bound_fma_ms=fma_ms)
            row.update(
                ms=time_ms(lambda: ssd.ssd_scan(*args, chunk=chunk)),
                plain_ms=time_ms(lambda: ssd_chunked_reference(
                    *args, chunk=chunk)),
                library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                reported=case == SSD_REPORTED)
            ops, _ = ssd_work(B, S, H, P, N, chunk, dt)
            row.update(graph_ms=graph_ms(lambda: ssd.ssd_scan(
                *args, chunk=chunk)))
            row.update(gflops=ops / row["graph_ms"] / 1e6,
                       bound_share=bound_ms / row["graph_ms"])
            print(f"[ssd] {name}: kernel {row['ms']:.4f} ms (calls back to "
                  f"back), {row['graph_ms']:.4f} ms (CUDA graph, device "
                  f"only), plain {row['plain_ms']:.4f} ms, library none, "
                  f"bound {bound_ms:.4f} ms ({bound_by}; at the FMA rate "
                  f"{fma_ms:.4f} ms), {row['gflops']:.0f} GFLOP/s and "
                  f"{100 * row['bound_share']:.1f}% of the bound on the "
                  f"device time, max_abs_err {err:.3g} [{smi}]")
        else:
            print(f"[ssd] {name}: max_abs_err {err:.3g}")
        if not ok:
            fail(f"ssd_scan disagrees with its plain version on {name}: "
                 f"max_abs_err {err} (atol {SSD_TOL}, rtol {rtol})")
        rows.append(row)
    return rows


def rglru_inputs(B, S, C, scale, with_h0, dt, gen, dev):
    """log_a = -|N(0,1)| x scale and gx = N(0,1), as tests/test_kernels.py
    draws them; or, for scale "model", at recurrentgemma-9b's scale:
    log_a = -8 softplus(lam) r with lam = 1 (the init) and r = sigmoid(N),
    gx = sqrt(1 - a^2) i x with i = sigmoid(N), x = N (the mixer's
    formulas). An optional f32 initial state."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    if scale == "model":
        log_a = -8.0 * float(F.softplus(torch.tensor(1.0))) * torch.sigmoid(
            randn(B, S, C))
        gx = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                    min=1e-12)) * torch.sigmoid(
            randn(B, S, C)) * randn(B, S, C)
    else:
        log_a = -randn(B, S, C).abs() * scale
        gx = randn(B, S, C)
    h0 = randn(B, C) if with_h0 else None
    return log_a.to(dt), gx.to(dt), h0


def rglru_bound(B, S, C, with_h0, dt) -> tuple[float, str]:
    """Least time for this call: rglru_work's bytes over the memory rate
    against its operations at the f32 rate (the arithmetic is f32 in
    either type)."""
    ops, nbytes = rglru_work(B, S, C, with_h0, dt)
    t_ops, t_bytes = ops / PEAK_OPS[torch.float32], nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def phase_rglru(dev, smi: str) -> list[dict]:
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    rows = []
    for case in RG_CASES + RG_SERVE:
        label, B, S, C, scale, with_h0, dt = case
        log_a, gx, h0 = rglru_inputs(B, S, C, scale, with_h0, dt, gen, dev)
        y, h = rg.rglru_scan(log_a, gx, h0)
        torch.cuda.synchronize()
        # the plain version in f32 on the same widened inputs: a bf16 h is
        # rounded once, half an ulp, at most 2^-8 of |h|
        yr, hr = rglru_scan_reference(log_a.float(), gx.float(), h0)
        rtol = RG_BF16_RTOL if dt == torch.bfloat16 else 0.0
        err = max((y.float() - yr).abs().max().item(),
                  (h - hr).abs().max().item())
        ok = (y.dtype == dt and h.dtype == torch.float32 and
              torch.allclose(y.float(), yr, atol=RG_TOL, rtol=rtol) and
              torch.allclose(h, hr, atol=RG_TOL, rtol=0.0))
        name = (f"{label} B={B} S={S} C={C} log_a scale {scale}"
                f"{' h0' if with_h0 else ''} {DT_NAME[dt]}")
        row = {"case": name, "max_abs_err": err, "tol": RG_TOL,
               "rtol": rtol, "ok": bool(ok)}
        if case in RG_SERVE:
            bound_ms, bound_by = rglru_bound(B, S, C, with_h0, dt)
            row.update(
                ms=time_ms(lambda: rg.rglru_scan(log_a, gx, h0)),
                plain_ms=time_ms(lambda: rglru_scan_reference(log_a, gx, h0),
                                 iters=3, warmup=1),
                library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                reported=case == RG_REPORTED)
            _, nbytes = rglru_work(B, S, C, with_h0, dt)
            row.update(graph_ms=graph_ms(lambda: rg.rglru_scan(
                log_a, gx, h0)))
            row.update(gbps=nbytes / row["graph_ms"] / 1e6,
                       bound_share=bound_ms / row["graph_ms"])
            print(f"[rglru] {name}: kernel {row['ms']:.4f} ms (calls back "
                  f"to back), {row['graph_ms']:.4f} ms (CUDA graph, device "
                  f"only), plain {row['plain_ms']:.4f} ms, library none, "
                  f"bound {bound_ms:.4f} ms ({bound_by}), "
                  f"{row['gbps']:.0f} GB/s and "
                  f"{100 * row['bound_share']:.1f}% of the bound on the "
                  f"device time, max_abs_err {err:.3g} [{smi}]")
        else:
            print(f"[rglru] {name}: max_abs_err {err:.3g}")
        if not ok:
            fail(f"rglru_scan disagrees with its plain version on {name}: "
                 f"max_abs_err {err} (atol {RG_TOL}, rtol {rtol})")
        rows.append(row)
    return rows


def glue_inputs(B: int, S: int, dt, gen, dev) -> tuple[tuple, tuple]:
    """Operands of the two glue kernels at mamba2-1.3b's widths (d_inner
    4096, N 128, 64 heads of 64): the in projections of unit scale, conv
    weights of std 0.5, dt of std 0.1 and dt_bias about -4; y and x of
    the scan unit normal in f32, z unit, D and the norm's weight 1 + 0.1
    N(0, 1)."""
    def r(*shape, scale=1.0, shift=0.0, d=dt):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                + shift).to(d)
    DI, N, H, P = 4096, 128, 64, 64
    conv = (r(B, S, DI), r(B, S, N), r(B, S, N), r(B, S, H, scale=0.1),
            r(4, DI, scale=0.5), r(4, N, scale=0.5), r(4, N, scale=0.5),
            r(H, shift=-4.0))
    norm = (r(B, S, H, P, d=torch.float32), r(B, S, H, P, d=torch.float32),
            r(B, S, DI), r(H, scale=0.1, shift=1.0),
            r(DI, scale=0.1, shift=1.0))
    return conv, norm


def check_conv_act(got, want, args, name: str) -> float:
    """tests/test_torch_ssm_glue.py's bounds: x, B and C within the plain
    version's bf16 rounding of its products and partial sums (7 u m, m
    the sum of the terms' magnitudes, plus one rounding of each side) and
    within one rounding of silu of a float64 conv; dt' within 2 f32 ulps;
    the conv states exact. Returns the largest |kernel - plain|."""
    xin, Bm, Cm, dtv, wx, wb, wc, _ = args
    u = UNIT_ROUNDOFF[xin.dtype]
    B, S, DI = xin.shape
    gx = got[0].reshape(B, S, DI)
    err = 0.0
    for g, p, x, w in ((gx, want[0].reshape(B, S, DI), xin, wx),
                       (got[1], want[1], Bm, wb), (got[2], want[2], Cm, wc)):
        xp = torch.cat([torch.zeros_like(x[:, :3]), x], 1).double()
        terms = [xp[:, i:i + S] * w[i].double() for i in range(4)]
        exact, m = sum(terms), sum(t.abs() for t in terms)
        oracle = F.silu(exact)
        g, p = g.double(), p.double()
        err = max(err, (g - p).abs().max().item())
        if not bool(((g - p).abs() <= u * (8 * m + g.abs() + p.abs())
                     + 1e-30).all()) or not bool(
                ((g - oracle).abs() <= u * oracle.abs() + 2.0 ** -21 * m
                 + 1e-30).all()):
            fail(f"(c6) ssm_conv_act {name}: beyond the rounding bounds "
                 f"(max |kernel - plain| {err})")
        del xp, terms, exact, m, oracle
    err = max(err, (got[3] - want[3]).abs().max().item())
    if not torch.allclose(got[3], want[3], rtol=2.0 ** -22, atol=0.0):
        fail(f"(c6) ssm_conv_act {name}: dt' differs from the plain "
             f"version's beyond 2 f32 ulps")
    for a, b in zip(got[4], want[4]):
        if a.dtype != xin.dtype or not torch.equal(a, b):
            fail(f"(c6) ssm_conv_act {name}: a conv state differs")
    return err


def check_gate_norm(got, want, name: str) -> float:
    """tests/test_torch_ssm_glue.py's bounds: within four steps of the
    dtype (2^-5 of the value in bf16, 1e-6 in f32), and in bf16 under
    1e-3 of the elements differing at all. Returns the largest
    |kernel - plain|."""
    bf16 = want.dtype == torch.bfloat16
    err = (got.float() - want.float()).abs().max().item()
    if got.dtype != want.dtype or not torch.allclose(
            got.float(), want.float(), rtol=2.0 ** -5 if bf16 else 1e-6,
            atol=1e-30):
        fail(f"(c6) ssm_gate_norm {name}: beyond four steps of the dtype "
             f"(max |kernel - plain| {err})")
    if bf16 and float((got != want).float().mean()) >= 1e-3:
        fail(f"(c6) ssm_gate_norm {name}: {float((got != want).float().mean())}"
             f" of the elements differ (at most 1e-3)")
    return err


def phase_glue(dev, smi: str) -> list[dict]:
    """(c6): each glue kernel against its plain version on GLUE_CASES, one
    launch a call; the timed cases back to back, in a CUDA graph and
    beside the bytes bound (roofline.work's formulas at 3.35 TB/s)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    rows = []
    for case in GLUE_CASES:
        B, S, dt = case
        conv, norm = glue_inputs(B, S, dt, gen, dev)
        name = f"B={B} S={S} {DT_NAME[dt]}"
        for kname, fn, plain, args, nbytes in (
                ("ssm_conv_act", glue.ssm_conv_act, glue.conv_act_plain,
                 conv, ssm_conv_act_work(B, S, 4096, 128, 64, 4, dt)[1]),
                ("ssm_gate_norm",
                 lambda *a: glue.ssm_gate_norm(*a, 1e-5),
                 lambda *a: MB._gate_norm(*a, 1e-5), norm,
                 ssm_gate_norm_work(B, S, 4096, 64, dt)[1])):
            before = glue.launches
            got = fn(*args)
            torch.cuda.synchronize()
            if glue.launches != before + 1:
                fail(f"(c6) {kname} {name}: {glue.launches - before} "
                     f"launches a call")
            want = plain(*args)
            err = (check_conv_act(got, want, args, name)
                   if kname == "ssm_conv_act"
                   else check_gate_norm(got, want, name))
            del got, want
            row = {"kernel": kname, "case": name, "max_abs_err": err,
                   "ok": True}
            if case in GLUE_TIMED:
                bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
                row.update(ms=time_ms(lambda: fn(*args)),
                           plain_ms=time_ms(lambda: plain(*args)),
                           graph_ms=graph_ms(lambda: fn(*args)),
                           library_ms=None, bound_ms=bound_ms,
                           bound_by="bytes",
                           reported=case == GLUE_REPORTED)
                row["bound_share"] = bound_ms / row["graph_ms"]
                print(f"[glue] {kname} {name}: kernel {row['ms']:.4f} ms "
                      f"(calls back to back), {row['graph_ms']:.4f} ms (CUDA "
                      f"graph, device only), plain {row['plain_ms']:.4f} "
                      f"ms, bound {bound_ms:.4f} ms (bytes, {nbytes} B), "
                      f"{100 * row['bound_share']:.1f}% of the bound on the "
                      f"device time, max_abs_err {err:.3g} [{smi}]")
            else:
                print(f"[glue] {kname} {name}: max_abs_err {err:.3g}")
            rows.append(row)
        del conv, norm
    torch.cuda.empty_cache()
    return rows


def batch_caches(caches, lens, max_seq: int) -> dict:
    """Batch-1 prefill caches -> one batched decode cache, as the engine
    fills its slots: every attention leaf ("k", "v": (L, 1, S_i, Hkv, D))
    zero-padded into an (L, B, max_seq, Hkv, D) buffer at rows [0, S_i),
    every state leaf concatenated along the batch. Rows past a sequence's
    length are never read (decode_attention masks kpos > pos)."""
    def walk(name, leaves):
        if isinstance(leaves[0], dict):
            return {k: walk(k, [c[k] for c in leaves]) for k in leaves[0]}
        if name in ("k", "v"):
            a = leaves[0]
            out = a.new_zeros((a.shape[0], len(leaves), max_seq)
                              + tuple(a.shape[3:]))
            for i, (c, n) in enumerate(zip(leaves, lens)):
                out[:, i, :n] = c[:, 0]
            return out
        return torch.cat(leaves, dim=1)
    return walk(None, list(caches))


def leaves(tree, path=()):
    """(path, leaf) pairs of a nested dict."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in leaves(v, path + (k,))]
    return [("/".join(path), tree)]


def greedy_oracle(api, params, prompt, n_new: int, dev,
                  extra=None) -> list[int]:
    """Greedy rollout by re-prefilling the whole sequence each step;
    ``extra`` holds a vlm's patches or an audio model's frames."""
    toks = list(int(t) for t in prompt)
    out = []
    for _ in range(n_new):
        logits, _ = api.prefill_fn(
            params, {"tokens": torch.tensor([toks], device=dev),
                     **(extra or {})})
        nxt = int(torch.argmax(logits[0, -1]))
        out.append(nxt)
        toks.append(nxt)
    return out


def rollout_oracle(api, params, prompt, n_new: int, dev,
                   max_seq: int, extra=None) -> list[int]:
    """Greedy rollout of one request at batch 1: prefill_fn once, then
    decode_fn on a max_seq attention cache, as the engine does for its
    slots (state leaves are taken as prefill_fn returns them); ``extra``
    as in ``greedy_oracle``."""
    logits, pre = api.prefill_fn(
        params, {"tokens": torch.tensor([[int(t) for t in prompt]],
                                        device=dev), **(extra or {})})
    S_p = len(prompt)
    caches = batch_caches([pre], [S_p], max_seq)
    out = [int(torch.argmax(logits[0, -1]))]
    for i in range(n_new - 1):
        logits, caches = api.decode_fn(
            params, caches, torch.tensor([[out[-1]]], device=dev),
            torch.tensor([S_p + i], device=dev))
        out.append(int(torch.argmax(logits[0, -1])))
    return out


KERNELS = {"flash_attention": fa, "moe_gmm": gmm, "ssd_scan": ssd,
           "rglru_scan": rg, "ssm_glue": glue}


def reset_launches() -> None:
    for m in KERNELS.values():
        m.reset_launches()


def read_launches() -> dict:
    return {name: m.launches for name, m in KERNELS.items()}


def roofline_step(arch: str, what: str, fn, args, measured_ms: float,
                  dtype: str, tokens: int, smi: str, cfg=None) -> dict:
    """(r): ``fn(*args)`` once under the port's cost analysis (its launch
    counts are restored), its FLOPs and bytes as an H100 roofline cell,
    the bound (the larger of the compute and memory terms) against the
    step's measured time, and the share of the bound that time reaches."""
    res = analyze(fn, *args)
    torch.cuda.synchronize()
    row = RR.roofline_row(RR.cell(
        arch, what, res, dtype=dtype, tokens=tokens,
        n_params=cfg.n_params() if cfg is not None else None,
        n_active_params=cfg.n_active_params() if cfg is not None else None))
    out = {"flops": res["flops"], "bytes": res["bytes"],
           "bytes_inner_loops": res["bytes_inner_loops"], "ops": res["ops"],
           "kernels": res["kernels"], "collective_bytes":
           res["collective_total"], "compute_ms": row["compute_s"] * 1e3,
           "memory_ms": row["memory_s_kernel"] * 1e3,
           "collective_ms": row["collective_s"] * 1e3,
           "bound_ms": row["bound_s"] * 1e3, "bound_by": row["dominant"],
           "model_flops": row["model_flops_per_dev"], "dtype": dtype,
           "measured_ms": measured_ms,
           "share": row["bound_s"] * 1e3 / measured_ms,
           "top_bytes_ops": res["top_bytes_ops"][:6], "nvidia_smi": smi}
    print(f"[roofline] {arch} {what}: {res['flops'] / 1e9:.6g} GFLOP, "
          f"{res['bytes'] / 1e9:.6g} GB ({res['ops']} aten ops; "
          f"{res['bytes_inner_loops'] / 1e9:.6g} GB more inside kernel "
          f"wrappers; kernels {res['kernels'] or 'none'}); H100 {dtype} "
          f"terms: compute {out['compute_ms']:.6g} ms, memory "
          f"{out['memory_ms']:.6g} ms, collective {out['collective_ms']:.6g}"
          f" ms; bound {out['bound_ms']:.6g} ms ({out['bound_by']}); "
          f"measured {measured_ms:.6g} ms, {100 * out['share']:.2f}% of "
          f"the bound [{smi}]")
    return out


def phase_serving(dev, smi: str, arch: str, duration: float) -> dict:
    cfg = get_config(arch)
    moe = cfg.family == "moe"
    parallel = ParallelConfig(param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    # on a one-device mesh, as launch.serve builds it: nothing a DTensor
    api = build_model(cfg, parallel, dev, mesh=make_local_mesh(1, 1, dev))
    if api.sharded:
        fail(f"{arch}: a (1, 1) mesh gave a sharded model")
    t0 = time.perf_counter()
    params = api.init(seed=0)
    torch.cuda.synchronize()
    print(f"[serve] {arch} full width, {cfg.n_layers} layers, "
          f"{api.n_params() / 1e9:.3f} B params bf16, drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    lines = []

    def log(line):
        lines.append(line)
        print(f"{line} [{smi}]")

    reset_launches()
    t0 = time.perf_counter()
    res = serve.run(cfg, parallel, device=dev, n_requests=len(SERVE_PROMPTS),
                    max_new=SERVE_MAX_NEW, prompt_lens=SERVE_PROMPTS,
                    max_batch=4, max_seq=2048, duration=duration, api=api,
                    params=params, log=log)
    launches = read_launches()
    gmm_paths = dict(gmm.launches_by_path)
    flash_paths = check_flash_paths(f"serve {arch}",
                                    launches["flash_attention"], smi)
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    reqs = res["requests"]
    lat = res["latency_ms"]
    busy = res["busy_quantum_ms"]
    prefills = len(reqs) + 1                    # + the warm-up request
    decode_steps = res["engine"].decode_steps + 1   # + the warm-up's step
    expect = {"flash_attention": cfg.n_layers * prefills,
              "moe_gmm": 3 * cfg.n_layers * (prefills + decode_steps)
              if moe else 0, "ssd_scan": 0, "rglru_scan": 0, "ssm_glue": 0}
    print(f"[serve] {arch} launches {launches} (expected {expect}: "
          f"{prefills} prefills, {decode_steps} decode steps); "
          f"decode quantum response p50 {np.percentile(lat, 50):.3f} ms, "
          f"p99 {np.percentile(lat, 99):.3f} ms over {len(lat)} quanta; "
          f"busy quanta (refill + decode) p50 "
          f"{np.percentile(busy, 50):.3f} ms, p99 "
          f"{np.percentile(busy, 99):.3f} ms, max {busy.max():.3f} ms over "
          f"{len(busy)}; "
          f"be_quanta {res['stats']['be_quanta']}; peak memory "
          f"{peak_gb:.2f} GB; run {wall:.1f} s [{smi}]")
    not_done = [r.rid for r in reqs
                if not r.done or len(r.out) != SERVE_MAX_NEW]
    if not_done:
        fail(f"{arch}: requests {not_done} did not finish with "
             f"{SERVE_MAX_NEW} tokens")
    for name, n in expect.items():
        if launches[name] != n:
            fail(f"{arch}: {name} launched {launches[name]} times on the "
                 f"serve path, expected {n}")
    if moe:
        # every prefill (the warm-up's prompt is the first) whose capacity
        # buffer holds more than 16 rows runs on the wgmma path; the
        # others and every decode step on the swap path (wgmma, operands
        # swapped); none on fill or fma
        caps = [M._capacity(T, cfg.moe.top_k, cfg.moe.n_experts,
                            cfg.moe.capacity_factor)
                for T in (SERVE_PROMPTS[0], *SERVE_PROMPTS)]
        wide = 3 * cfg.n_layers * sum(c > 16 for c in caps)
        print(f"[serve] {arch} moe_gmm launches by path {gmm_paths}: "
              f"prefill capacities {caps}, {wide} launches with C > 16 "
              f"[{smi}]")
        if gmm_paths["wgmma"] != wide or gmm_paths["fill"] or \
                gmm_paths["fma"] or gmm_paths["tf32x3"] or \
                gmm_paths["swap"] != expect["moe_gmm"] - wide:
            fail(f"{arch}: moe_gmm took {gmm_paths}; the {wide} launches "
                 f"with C > 16 must all take wgmma, the "
                 f"{expect['moe_gmm'] - wide} others swap")
    # the engine alone (no executor, no best-effort thread): one decode
    # step over 4 busy slots and one 1024-token prefill, host clock around
    # work that ends in a synchronize
    engine = ServingEngine(api, params, max_batch=4, max_seq=2048)
    rng = np.random.default_rng(5)
    for i in range(4):
        engine.add_request(Request(rid=i, max_new=10**6, prompt=rng.integers(
            0, cfg.vocab_size, size=(32,)).astype(np.int32)))
    steps = []
    for _ in range(12):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.decode_step()
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, 1024)),
                             device=dev)
    pre = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        api.prefill_fn(params, {"tokens": tokens})
        torch.cuda.synchronize()
        pre.append((time.perf_counter() - t0) * 1e3)
    step_ms = float(np.median(steps[2:]))
    prefill_ms = float(np.median(pre[1:]))
    print(f"[serve] {arch} engine alone: decode step (4 slots) median "
          f"{step_ms:.3f} ms of {len(steps) - 2}, 1024-token prefill median "
          f"{prefill_ms:.3f} ms of {len(pre) - 1} [{smi}]")
    roof = {"decode": roofline_step(
        arch, "decode step (4 slots)", engine.decode_step, (), step_ms,
        "bfloat16", 4, smi, cfg),
        "prefill": roofline_step(
            arch, "1024-token prefill", api.prefill_fn,
            (params, {"tokens": tokens}), prefill_ms, "bfloat16", 1024, smi,
            cfg)}
    del engine
    # bf16 oracle, reported only: bf16 rounding differs between the batched
    # decode step and the oracle, so near-ties may flip (phase e/e2 checks)
    r0 = reqs[0]
    o16 = rollout_oracle(api, params, r0.prompt, SERVE_MAX_NEW, dev, 2048) \
        if moe else greedy_oracle(api, params, r0.prompt, SERVE_MAX_NEW, dev)
    agree = next((i for i, (a, b) in enumerate(zip(r0.out, o16)) if a != b),
                 SERVE_MAX_NEW)
    kind = "batch-1 rollout" if moe else "re-prefill rollout"
    print(f"[serve] {arch} bf16 request 0: first {agree}/{SERVE_MAX_NEW} "
          f"tokens equal the bf16 {kind} (reported, not checked)")
    return {"api": api, "params": params, "launches": launches,
            "moe_gmm_paths": gmm_paths if moe else None,
            "flash_paths": flash_paths,
            "prefills": prefills, "decode_steps": decode_steps,
            "decode_p50_ms": float(np.percentile(lat, 50)),
            "decode_p99_ms": float(np.percentile(lat, 99)),
            "decode_quanta": int(len(lat)),
            "busy_p50_ms": float(np.percentile(busy, 50)),
            "busy_p99_ms": float(np.percentile(busy, 99)),
            "busy_max_ms": float(busy.max()), "busy_quanta": int(len(busy)),
            "be_quanta": res["stats"]["be_quanta"], "peak_gb": peak_gb,
            "bf16_oracle_prefix": agree, "engine_decode_step_ms": step_ms,
            "engine_prefill_1024_ms": prefill_ms, "roofline": roof,
            "lines": lines}


def plain_ssd_scan(xh, dt, Bm, Cm, A, *, chunk):
    """ssd_scan's plain version with the wrapper's interface."""
    y, h = ssd_chunked_reference(xh, dt, Bm, Cm, A, chunk=chunk)
    return y.to(xh.dtype), h


def through_plain(fn):
    """fn() run with each kernel's wrapper swapped for its plain version."""
    saved = (M.grouped_matmul, L.flash_attention, MB.ssd_scan,
             RG.rglru_scan, MB.ssm_conv_act, MB.ssm_gate_norm)
    (M.grouped_matmul, L.flash_attention, MB.ssd_scan, RG.rglru_scan,
     MB.ssm_conv_act, MB.ssm_gate_norm) = (
        gmm_reference, naive_attention, plain_ssd_scan, rglru_scan_reference,
        glue.conv_act_plain, MB._gate_norm)
    try:
        return fn()
    finally:
        (M.grouped_matmul, L.flash_attention, MB.ssd_scan, RG.rglru_scan,
         MB.ssm_conv_act, MB.ssm_gate_norm) = saved


def check_plain_path(api, params, dev, max_seq: int) -> dict:
    """The f32 logits through the kernels equal those of the same calls with
    each kernel's wrapper swapped for its plain version, within
    PLAIN_PATH_TOL: a prefill, then PLAIN_PATH_STEPS decode steps over one
    slot per prompt of PLAIN_PATH_PROMPTS, each slot at its own position,
    on the same teacher-forced tokens; the caches after them too. The whole
    model checked at full width, beyond what the greedy tokens of random
    weights show."""
    cfg = api.cfg
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size, size=(n,))
               for n in PLAIN_PATH_PROMPTS]
    feed = torch.as_tensor(rng.integers(
        1, cfg.vocab_size, size=(PLAIN_PATH_STEPS, len(prompts), 1)),
        device=dev)
    lens = torch.tensor(PLAIN_PATH_PROMPTS, device=dev)
    errs = {}

    def check(what, got, want):
        err = (got - want).abs().max().item()
        errs[what] = max(errs.get(what, 0.0), err)
        if not torch.allclose(got, want, atol=PLAIN_PATH_TOL,
                              rtol=PLAIN_PATH_TOL):
            fail(f"{cfg.name}: f32 {what} through the kernels differ from "
                 f"the plain versions' by {err}")

    batch = {"tokens": torch.as_tensor(prompts[0][None], device=dev)}
    got, _ = api.prefill_fn(params, batch)
    want, _ = through_plain(lambda: api.prefill_fn(params, batch))
    check("prefill logits", got, want)
    # slot caches filled by batch-1 prefills, as the engine fills them
    caches = batch_caches(
        [api.prefill_fn(params, {"tokens": torch.as_tensor(
            p[None], device=dev)})[1] for p in prompts],
        PLAIN_PATH_PROMPTS, max_seq)

    def decode():
        c = {n: t.clone() for n, t in caches.items()}
        logits = []
        for j in range(PLAIN_PATH_STEPS):
            out, c = api.decode_fn(params, c, feed[j], lens + j)
            logits.append(out)
        return torch.stack(logits), c

    got, got_c = decode()
    want, want_c = through_plain(decode)
    check("decode logits", got, want)
    for n in ("k", "v"):
        check("decode caches", got_c[n], want_c[n])
    print(f"[oracle] {cfg.name} f32, kernels vs plain versions: max_abs_err "
          + ", ".join(f"{w} {e:.3g}" for w, e in errs.items())
          + f" (prefill, then {PLAIN_PATH_STEPS} decode steps over "
          f"{len(prompts)} slots at positions {PLAIN_PATH_PROMPTS}; logits "
          f"std {want.std().item():.3g}, tolerance {PLAIN_PATH_TOL})")
    return errs


def phase_oracle(dev, api16, params16, n_layers: int = 0,
                 plain_path: bool = False) -> dict:
    """(e) for the dense model: the re-prefill oracle; (e2) for MoE: the
    batch-1 prefill + decode rollout (see the module docstring). The f32
    copy keeps the first ``n_layers`` layers of the bf16 weights where it
    is given (granite-20b's would not fit in f32); ``plain_path`` adds
    ``check_plain_path``, which MoE always runs. Every flash launch of the
    phase must take the tf32x3 path."""
    moe = api16.cfg.family == "moe"
    reset_launches()
    cfg = dataclasses.replace(api16.cfg, dtype="float32")
    first = slice(None)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
        first = slice(n_layers)
        print(f"[oracle] {cfg.name} f32: depth cut {api16.cfg.n_layers} -> "
              f"{n_layers} layers (the first {n_layers} of the bf16 "
              f"weights)")
    parallel = ParallelConfig(param_dtype="float32", compute_dtype="float32")
    api = build_model(cfg, parallel, dev)
    params = api.load(L.tree_map(
        lambda path, a: (a[first] if path[0] == "blocks" else a).float(),
        params16))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, size=(n,)).astype(np.int32)
               for n in (32, 20)]
    reqs = [Request(rid=i, prompt=p, max_new=n)
            for i, (p, n) in enumerate(zip(prompts, (16, 8)))]
    engine = ServingEngine(api, params, max_batch=2, max_seq=128)
    engine.run_until_done(reqs, max_steps=100)
    kind = "batch-1 rollout" if moe else "re-prefill"
    for r in reqs:
        oracle = rollout_oracle(api, params, r.prompt, r.max_new, dev, 128) \
            if moe else greedy_oracle(api, params, r.prompt, r.max_new, dev)
        print(f"[oracle] {cfg.name} f32 request {r.rid}: engine {r.out}")
        print(f"[oracle] {cfg.name} f32 request {r.rid}: {kind} {oracle}")
        if not r.done or r.out != oracle:
            fail(f"{cfg.name}: f32 engine tokens of request {r.rid} differ "
                 f"from the {kind} greedy oracle")
    print(f"[oracle] {cfg.name} f32 engine tokens equal the {kind} oracle on "
          f"both requests")
    errs = check_plain_path(api, params, dev, 128) \
        if moe or plain_path else {}
    check_f32_flash_paths(f"{cfg.name} f32 oracle", nvidia_smi())
    if moe:
        check_f32_gmm_paths(f"{cfg.name} f32 oracle", nvidia_smi())
    del params
    return errs


def phase_softcap_model(dev, smi: str) -> dict:
    """(x): qwen2-7b at full width with ``logit_softcap`` 1.0, depth cut to
    SOFTCAP_MODEL_LAYERS, f32 from seed 0: ``check_plain_path`` (a
    prefill, then 4 decode steps over 4 slots, logits and caches through
    the kernel against the plain versions at PLAIN_PATH_TOL) and one
    SOFTCAP_MODEL_PROMPT-token prefill the same way (several kv tiles);
    flash must launch exactly n_layers x 6 times (the prefills through
    the kernel; decode attention is torch ops, as in JAX). The same
    weights without the cap must give other logits."""
    cfg = dataclasses.replace(
        get_config(SOFTCAP_MODEL_ARCH), n_layers=SOFTCAP_MODEL_LAYERS,
        logit_softcap=SOFTCAP_MODEL_CAP, dtype="float32")
    parallel = ParallelConfig(param_dtype="float32", compute_dtype="float32")
    api = build_model(cfg, parallel, dev)
    params = api.init(seed=0)
    rng = np.random.default_rng(6)
    batch = {"tokens": torch.as_tensor(rng.integers(
        1, cfg.vocab_size, size=(1, SOFTCAP_MODEL_PROMPT)), device=dev)}
    reset_launches()
    errs = check_plain_path(api, params, dev, 128)
    got, _ = api.prefill_fn(params, batch)
    launches = read_launches()
    want, _ = through_plain(lambda: api.prefill_fn(params, batch))
    err = (got - want).abs().max().item()
    errs[f"prefill {SOFTCAP_MODEL_PROMPT} logits"] = err
    if not torch.allclose(got, want, atol=PLAIN_PATH_TOL,
                          rtol=PLAIN_PATH_TOL):
        fail(f"(x) softcapped {cfg.name}: the {SOFTCAP_MODEL_PROMPT}-token "
             f"prefill through the kernel differs from the plain version's "
             f"by {err}")
    expect = {k: 0 for k in KERNELS}
    expect["flash_attention"] = cfg.n_layers * (2 + len(PLAIN_PATH_PROMPTS))
    if launches != expect:
        fail(f"(x) softcapped {cfg.name}: launches {launches}, expected "
             f"{expect}")
    flash_paths = check_f32_flash_paths(f"(x) softcapped {cfg.name}", smi)
    plain_api = build_model(dataclasses.replace(cfg, logit_softcap=0.0),
                            parallel, dev)
    uncapped, _ = plain_api.prefill_fn(params, batch)
    moved = (uncapped - got).abs().max().item()
    if moved <= PLAIN_PATH_TOL:
        fail(f"(x) the softcap moves {cfg.name}'s logits by {moved} only")
    print(f"[softcap] {cfg.name} f32, {cfg.n_layers} layers, logit_softcap "
          f"{SOFTCAP_MODEL_CAP}: kernel vs plain max_abs_err "
          + ", ".join(f"{w} {e:.3g}" for w, e in errs.items())
          + f" (tolerance {PLAIN_PATH_TOL}); launches {launches}; the cap "
          f"moves the prefill logits by {moved:.3g} [{smi}]")
    del params
    return {"errs": errs, "launches": launches, "cap_moves_logits_by": moved,
            "flash_paths": flash_paths}


def phase_bench_run(smi: str) -> dict:
    """(w): the port's aggregator, ``repro_torch.benchmarks.run.main([
    "--duration", "1"])``, on the card: fails unless every section printed
    in order, Fig.6 ran a DNN quantum in each mode, and the roofline
    section read each cell (u) wrote. None of the four kernels may
    launch."""
    before = read_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rep = bench_run.main(["--duration", "1"])
    out = buf.getvalue()
    print(out, end="")
    at = [out.find(h) for h in ("== fig4, fig5, table3, sim engines",
                                "== fig1 ", "== fig6 ", "== roofline ",
                                "== done in ")]
    if -1 in at or at != sorted(at):
        fail(f"(w) the aggregator's sections are missing or out of order: "
             f"{at}")
    for mode in ("solo", "cosched", "rtgang"):
        if rep["fig6"].get(mode, {}).get("n", 0) < 1:
            fail(f"(w) fig6 ran no DNN quantum under {mode}")
    cells = {(r["arch"], r["shape"]) for r in rep["roofline"]}
    missing = [c[:2] for c in DRYRUN_CELLS if c[:2] not in cells]
    if missing:
        fail(f"(w) the roofline section lacks (u)'s cells {missing}")
    if read_launches() != before:
        fail(f"(w) launched {read_launches()}: the aggregator's paths have "
             f"none of the four kernels")
    print(f"[bench] aggregator: fig1 {len(rep['fig1'])} rows, fig6 modes "
          f"{sorted(rep['fig6'])}, roofline {len(rep['roofline'])} cells "
          f"[{smi}]")
    return {"fig1": rep["fig1"], "fig6": rep["fig6"],
            "roofline_cells": len(rep["roofline"])}


def gang_expect(cfg, n_prefills: int) -> dict:
    """Kernel launches of a gang run: per prefill, one scan for each
    recurrent layer (ssd_scan for Mamba2, rglru_scan for RG-LRU) and one
    flash for each attention layer, which for Whisper is each encoder
    layer and twice each decoder layer (self and cross; ``layer_kinds``
    lists the decoder's only), and for Mamba2 the two glue kernels around
    each scan (ssm_conv_act, ssm_gate_norm); a decode step launches no
    kernel."""
    kinds = cfg.layer_kinds()
    n_attn = kinds.count("attn")
    if cfg.family == "audio":
        n_attn = cfg.n_encoder_layers + 2 * cfg.n_layers
    return {"flash_attention": n_attn * n_prefills,
            "moe_gmm": 0, "ssd_scan": kinds.count("ssm") * n_prefills,
            "rglru_scan": kinds.count("rec") * n_prefills,
            "ssm_glue": 2 * kinds.count("ssm") * n_prefills}


def stub_inputs(cfg, seed: int, dev) -> dict:
    """A batch-1 prompt's stub-tower inputs, normal x 0.02 (the data
    pipeline's scale) from ``seed`` on the card: {"patches" (1,
    n_vision_tokens, D)} for vlm, {"frames" (1, n_encoder_frames, D)} for
    audio, nothing for the token-only families."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    if cfg.family == "vlm":
        n, name = cfg.n_vision_tokens, "patches"
    elif cfg.family == "audio":
        n, name = cfg.n_encoder_frames, "frames"
    else:
        return {}
    return {name: torch.randn((1, n, cfg.d_model), generator=gen,
                              device=dev) * 0.02}


def phase_gang(dev, smi: str, arch: str, duration: float,
               max_seq: int, prompt_lens=GANG_PROMPTS) -> dict:
    """(d3) / (d4) / (m) / (n): the batched decode step of a model served
    through prefill_fn / decode_fn (mamba2-1.3b, recurrentgemma-9b,
    internvl2-1b, whisper-base) as the RT gang, after batch-1 prefills of
    ``prompt_lens`` tokens (with patches or frames where the family takes
    them)."""
    cfg = get_config(arch)
    if cfg.family == "audio" and cfg.n_encoder_frames != AUDIO_FRAMES:
        fail(f"{arch} has {cfg.n_encoder_frames} frames; (c) checks flash "
             f"at {AUDIO_FRAMES}")
    parallel = ParallelConfig(param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    api = build_model(cfg, parallel, dev)
    t0 = time.perf_counter()
    params = api.init(seed=0)
    torch.cuda.synchronize()
    print(f"[{arch}] full width, {cfg.n_layers} layers, "
          f"{api.n_params() / 1e9:.3f} B params bf16, drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    batches = [{"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab_size, size=(1, n)), device=dev),
        **stub_inputs(cfg, i, dev)} for i, n in enumerate(prompt_lens)]
    lens = torch.tensor(prompt_lens, device=dev)
    # warm-up, outside the counted run: a prefill and a decode step
    _, c = api.prefill_fn(params, batches[0])
    api.decode_fn(params, batch_caches([c], prompt_lens[:1], max_seq),
                  batches[0]["tokens"][:, :1], lens[:1])
    del c
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    state = {"caches": None, "tok": None}
    out, busy_ms = [], []

    def decode_quantum(lane, idx):
        """The first quantum prefills the 4 prompts; each later one decodes
        one token of all 4 sequences, until each has GANG_NEW."""
        if len(out) == GANG_NEW:
            return
        t0 = time.perf_counter()
        if state["caches"] is None:
            pre = [api.prefill_fn(params, b) for b in batches]
            state["caches"] = batch_caches([c for _, c in pre],
                                           prompt_lens, max_seq)
            state["tok"] = torch.cat([lg[:, -1].argmax(-1, keepdim=True)
                                      for lg, _ in pre])
        else:
            logits, _ = api.decode_fn(params, state["caches"], state["tok"],
                                      lens + len(out) - 1)
            state["tok"] = logits[:, -1].argmax(-1, keepdim=True)
        out.append(state["tok"])
        busy_ms.append((time.perf_counter() - t0) * 1e3)

    reset_launches()
    t0 = time.perf_counter()
    stats = serve.run_gang(decode_quantum, dev, duration)
    launches = read_launches()
    flash_paths = check_flash_paths(f"{arch} gang",
                                    launches["flash_attention"], smi)
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    lat = np.array(stats["response_times"].get("decode", [0.0])) * 1e3
    busy = np.array(busy_ms)
    n_seq = len(prompt_lens)
    expect = gang_expect(cfg, n_seq)
    print(f"[{arch}] gang: launches {launches} (expected {expect}: "
          f"{n_seq} prefills, {max(len(out) - 1, 0)} decode "
          f"steps over {n_seq} sequences); decode quantum "
          f"response p50 {np.percentile(lat, 50):.3f} ms, p99 "
          f"{np.percentile(lat, 99):.3f} ms over {len(lat)} quanta; busy "
          f"quanta (prefill + decode) p50 {np.percentile(busy, 50):.3f} ms, "
          f"p99 {np.percentile(busy, 99):.3f} ms, max {busy.max():.3f} ms "
          f"over {len(busy)}; be_quanta {stats['be_quanta']}; peak memory "
          f"{peak_gb:.2f} GB; run {wall:.1f} s [{smi}]")
    if len(out) != GANG_NEW:
        fail(f"{arch}: the gang made {len(out)} of {GANG_NEW} tokens per "
             f"sequence in {duration} s")
    for name, n in expect.items():
        if launches[name] != n:
            fail(f"{arch}: {name} launched {launches[name]} times on the "
                 f"gang path, expected {n}")
    tokens = torch.cat(out, dim=1)
    if tokens.shape != (n_seq, GANG_NEW) or \
            not bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
        fail(f"{arch}: gang tokens of shape {tuple(tokens.shape)} out of "
             f"range")
    # alone (no executor, no best-effort thread): one decode step over the
    # 4 sequences and one prefill of the longest prompt, host clock around
    # work that ends in a synchronize
    caches = L.tree_map(lambda _, t: t.clone(), state["caches"])
    steps = []
    reset_launches()
    for i in range(12):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        api.decode_fn(params, caches, state["tok"], lens + GANG_NEW + i)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
    if any(read_launches().values()):
        fail(f"{arch}: 12 decode steps alone launched {read_launches()}, "
             f"expected none")
    n_long = max(prompt_lens)
    longest = batches[prompt_lens.index(n_long)]
    pre = []
    reset_launches()
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        api.prefill_fn(params, longest)
        torch.cuda.synchronize()
        pre.append((time.perf_counter() - t0) * 1e3)
    if read_launches() != gang_expect(cfg, 4):
        fail(f"{arch}: 4 prefills alone launched {read_launches()}, "
             f"expected {gang_expect(cfg, 4)}")
    step_ms = float(np.median(steps[2:]))
    prefill_ms = float(np.median(pre[1:]))
    print(f"[{arch}] alone: decode step (4 sequences) median {step_ms:.3f} "
          f"ms of {len(steps) - 2}, {n_long}-token prefill median "
          f"{prefill_ms:.3f} ms of {len(pre) - 1} [{smi}]")
    roof = {"decode": roofline_step(
        arch, f"decode step ({n_seq} sequences)", api.decode_fn,
        (params, caches, state["tok"], lens + GANG_NEW + 12), step_ms,
        "bfloat16", n_seq, smi, cfg),
        "prefill": roofline_step(
            arch, f"{n_long}-token prefill", api.prefill_fn,
            (params, longest), prefill_ms, "bfloat16", n_long, smi, cfg)}
    del caches
    return {"api": api, "params": params, "launches": launches,
            "flash_paths": flash_paths,
            "prefills": n_seq, "decode_steps": len(out) - 1,
            "decode_p50_ms": float(np.percentile(lat, 50)),
            "decode_p99_ms": float(np.percentile(lat, 99)),
            "decode_quanta": int(len(lat)),
            "busy_p50_ms": float(np.percentile(busy, 50)),
            "busy_p99_ms": float(np.percentile(busy, 99)),
            "busy_max_ms": float(busy.max()), "busy_quanta": int(len(busy)),
            "be_quanta": stats["be_quanta"], "peak_gb": peak_gb,
            "decode_step_ms": step_ms, f"prefill_{n_long}_ms": prefill_ms,
            "roofline": roof, "tokens": tokens.tolist()}


def phase_gang_oracle(dev, api16, params16, max_seq: int,
                      prompt_lens=GANG_PROMPTS) -> dict:
    """(e3) / (e4) / (m2) / (n2): f32 at full width on the gang's weights
    (the bf16 copy is let go once the f32 one exists). For vlm and audio
    also decode after a prefill against a one-token-longer prefill, and
    the stub inputs scaled by -5 against the logits they gave."""
    cfg = dataclasses.replace(api16.cfg, dtype="float32")
    parallel = ParallelConfig(param_dtype="float32", compute_dtype="float32")
    api = build_model(cfg, parallel, dev)
    params = api.load(L.tree_map(lambda _, a: a.float(), params16))
    del params16
    gc.collect()
    torch.cuda.empty_cache()
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size, size=(n,))
               for n in prompt_lens]
    feed = torch.as_tensor(rng.integers(
        1, cfg.vocab_size, size=(PLAIN_PATH_STEPS, len(prompts), 1)),
        device=dev)
    lens = torch.tensor(prompt_lens, device=dev)
    extras = [stub_inputs(cfg, 10 + i, dev) for i in range(len(prompts))]
    batches = [{"tokens": torch.as_tensor(p[None], device=dev), **e}
               for p, e in zip(prompts, extras)]
    errs = {}

    def check(what, got, want):
        err = (got - want).abs().max().item()
        errs[what] = max(errs.get(what, 0.0), err)
        if not torch.allclose(got, want, atol=PLAIN_PATH_TOL,
                              rtol=PLAIN_PATH_TOL):
            fail(f"{cfg.name}: f32 {what} through the kernels differ from "
                 f"the plain versions' by {err}")

    def run():
        """The 4 prefills, then PLAIN_PATH_STEPS teacher-forced decode
        steps over the 4 sequences: (prefill logits, caches after the
        prefills, decode logits, caches after the decode steps)."""
        pre = [api.prefill_fn(params, b) for b in batches]
        caches = batch_caches([c for _, c in pre], prompt_lens, max_seq)
        first = L.tree_map(lambda _, t: t.clone(), caches)
        logits = []
        for j in range(PLAIN_PATH_STEPS):
            out, caches = api.decode_fn(params, caches, feed[j], lens + j)
            logits.append(out)
        return (torch.cat([lg for lg, _ in pre]), first,
                torch.stack(logits), caches)

    reset_launches()
    got = run()
    expect = gang_expect(cfg, len(prompts))
    if read_launches() != expect:
        fail(f"{cfg.name}: f32 prefills launched {read_launches()}, "
             f"expected {expect}")
    flash_paths = check_f32_flash_paths(f"{cfg.name} f32 oracle",
                                        nvidia_smi())
    want = through_plain(run)
    check("prefill logits", got[0], want[0])
    check("decode logits", got[2], want[2])
    for what, i in (("prefill caches", 1), ("decode caches", 3)):
        for (path, g), (_, w) in zip(leaves(got[i]), leaves(want[i])):
            check(f"{what} {path}", g, w)
    print(f"[oracle] {cfg.name} f32, kernels vs plain versions: max_abs_err "
          + ", ".join(f"{w} {e:.3g}" for w, e in errs.items())
          + f" (prefills of {prompt_lens} tokens, then {PLAIN_PATH_STEPS} "
          f"decode steps over the {len(prompts)} sequences; tolerance "
          f"{PLAIN_PATH_TOL})")
    extra_checks = {}
    if extras[0]:
        extra_checks = check_stub_family(api, params, batches, got[0],
                                         max_seq)
    del got, want

    # batched greedy decode == each sequence's batch-1 rollout
    pre = [api.prefill_fn(params, b) for b in batches]
    caches = batch_caches([c for _, c in pre], prompt_lens, max_seq)
    tok = torch.cat([lg[:, -1].argmax(-1, keepdim=True) for lg, _ in pre])
    del pre
    batched = [tok]
    for i in range(GANG_ORACLE_NEW - 1):
        logits, caches = api.decode_fn(params, caches, tok, lens + i)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        batched.append(tok)
    del caches
    batched = torch.cat(batched, dim=1).tolist()
    reprefill = []
    for i, (p, e) in enumerate(zip(prompts, extras)):
        alone = rollout_oracle(api, params, p, GANG_ORACLE_NEW, dev, max_seq,
                               e)
        print(f"[oracle] {cfg.name} f32 sequence {i}: batched {batched[i]}")
        print(f"[oracle] {cfg.name} f32 sequence {i}: batch-1 rollout "
              f"{alone}")
        if batched[i] != alone:
            fail(f"{cfg.name}: f32 batched greedy tokens of sequence {i} "
                 f"differ from its batch-1 rollout")
        again = greedy_oracle(api, params, p, GANG_ORACLE_NEW, dev, e)
        reprefill.append(next((k for k, (a, b) in enumerate(
            zip(batched[i], again)) if a != b), GANG_ORACLE_NEW))
    print(f"[oracle] {cfg.name} f32 batched tokens equal the batch-1 rollout "
          f"on all {len(prompts)} sequences; they equal a re-prefill rollout "
          f"for the first {reprefill} of {GANG_ORACLE_NEW} tokens "
          f"(reported, not checked)")
    check_f32_flash_paths(f"{cfg.name} f32 oracle, the whole phase",
                          nvidia_smi())
    del params
    return {"plain_path_err": errs, "reprefill_prefix": reprefill,
            "f32_flash_paths": flash_paths, **extra_checks}


def check_stub_family(api, params, batches, logits, max_seq: int) -> dict:
    """(m2) / (n2), f32: each sequence's last-token decode after a
    prefill of the rest equals the full prefill's logits (``logits``,
    (n, 1, V)) within DECODE_PREFILL_TOL, in one batched decode step
    (tests/test_models_smoke.py's check); the first sequence's stub
    inputs scaled by -5 change its logits by more than PLAIN_PATH_TOL."""
    cfg = api.cfg
    lens = [b["tokens"].shape[1] for b in batches]
    dev = logits.device
    pre = [api.prefill_fn(params, dict(b, tokens=b["tokens"][:, :-1]))
           for b in batches]
    caches = batch_caches([c for _, c in pre], [n - 1 for n in lens],
                          max_seq)
    got, _ = api.decode_fn(params, caches,
                           torch.cat([b["tokens"][:, -1:] for b in batches]),
                           torch.tensor(lens, device=dev) - 1)
    err = (got - logits).abs().max().item()
    print(f"[oracle] {cfg.name} f32: decode of each sequence's last token "
          f"after a prefill of the rest vs the full prefill: max_abs_err "
          f"{err:.3g} (tolerance {DECODE_PREFILL_TOL})")
    if not torch.allclose(got, logits, atol=DECODE_PREFILL_TOL,
                          rtol=DECODE_PREFILL_TOL):
        fail(f"{cfg.name}: decode after prefill differs from the longer "
             f"prefill by {err}")
    # the logits, and the cache leaf the stub inputs feed most directly:
    # the patches are the first positions' layer inputs, so every layer's
    # k; the frames reach the decoder only through cross_k. whisper's
    # logits move little: its sinusoidal positions, O(1), dominate frames
    # of normal x 0.02 in the encoder's input
    name, leaf = (("patches", "k") if cfg.family == "vlm"
                  else ("frames", "cross_k"))
    flipped = dict(batches[0], **{name: batches[0][name] * -5.0})
    flip_logits, flip_cache = api.prefill_fn(params, flipped)
    moved = (flip_logits - logits[:1]).abs().max().item()
    moved_leaf = (flip_cache[leaf] - api.prefill_fn(params, batches[0])[1][
        leaf]).abs().max().item()
    print(f"[oracle] {cfg.name} f32: {name} x -5 move sequence 0's logits "
          f"by {moved:.3g} and its {leaf} by {moved_leaf:.3g} (each must "
          f"exceed {PLAIN_PATH_TOL})")
    if not moved > PLAIN_PATH_TOL:
        fail(f"{cfg.name}: the {name} do not reach the logits")
    if not moved_leaf > PLAIN_PATH_TOL:
        fail(f"{cfg.name}: the {name} do not reach {leaf}")
    return {"decode_vs_prefill_err": err, f"{name}_moved": moved,
            f"{name}_moved_{leaf}": moved_leaf}


def device_events(fn, name: str) -> list[dict]:
    """The device events of ``fn()`` under ``torch.profiler``
    (``build/trace_<name>.json``)."""
    return fig1_trace.device_events(fn, ROOT / "build" / f"trace_{name}.json")


def dave2_flops(cfg, batch: int) -> int:
    """Operations of one forward: 2 per multiply-add of the convs and the
    fc products (bias adds and tanh not counted)."""
    h, w = cfg.input_hw
    c_in, ops = cfg.in_channels, 0
    for c_out, k, s in cfg.conv:
        h, w = (h - k) // s + 1, (w - k) // s + 1
        ops += 2 * k * k * c_in * c_out * h * w
        c_in = c_out
    dims = (h * w * c_in,) + cfg.fc + (cfg.n_outputs,)
    ops += sum(2 * a * b for a, b in zip(dims, dims[1:]))
    return batch * ops


def dave2_scaled_params(cfg, gen) -> dict:
    """DAVE-2 weights at std 1/sqrt(fan_in) of the HWIO / (in, out) shape
    and biases N(0, 0.1): unlike the init rule's (zero biases, conv
    pre-activations of std ~k that saturate tanh), a dropped bias or a
    flipped kernel changes the output."""
    out = {}
    for k, d in DV.dave2_defs(cfg).items():
        if k.endswith("_b"):
            out[k] = torch.randn(d.shape, generator=gen) * 0.1
        else:
            v = torch.randn(d.shape, generator=gen) / np.sqrt(
                np.prod(d.shape[:-1]))
            out[k] = DV.conv_weight(v) if v.dim() == 4 else v
    return out


def phase_dave2(dev, smi: str) -> dict:
    """(f) DAVE-2 on the card against the same module on the CPU, and its
    B=1 forward's time back to back, in a CUDA graph and as device
    events."""
    cfg = DAVE2
    params, model = DV.make_dave2(
        cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    weights = {"init rule": params,
               "scaled": {k: v.to(dev) for k, v in
                          dave2_scaled_params(cfg, gen).items()}}
    errs = {}
    for label, p in weights.items():
        card = DV.Dave2(cfg, p)
        cpu = DV.Dave2(cfg, {k: v.cpu() for k, v in p.items()})
        for b in DAVE2_BATCHES:
            x = torch.rand((b, *cfg.input_hw, cfg.in_channels), generator=gen)
            got, want = card(x.to(dev)).cpu(), cpu(x)
            if got.shape != (b, cfg.n_outputs) or \
                    not torch.isfinite(got).all():
                fail(f"dave2 {label} B={b}: output {tuple(got.shape)}, "
                     f"finite {bool(torch.isfinite(got).all())}")
            errs[f"{label} B={b}"] = float((got - want).abs().max())
            if errs[f"{label} B={b}"] > DAVE2_TOL:
                fail(f"dave2 {label} B={b}: card vs CPU max_abs_err "
                     f"{errs[f'{label} B={b}']:.3g} > {DAVE2_TOL}")
    print("[dave2] f32 (TF32 off), card vs the same module on the CPU: "
          "max_abs_err " + ", ".join(f"{k} {e:.3g}" for k, e in errs.items())
          + f" (tolerance {DAVE2_TOL})")

    x1 = torch.ones((1, *cfg.input_hw, cfg.in_channels), device=dev)
    fwd = functools.partial(model, x1)
    ms, g_ms = time_ms(fwd, iters=100), graph_ms(fwd, iters=20)
    n_fwd = 20
    events = device_events(lambda: [fwd() for _ in range(n_fwd)], "dave2")
    busy_ms = sum(e["dur"] for e in events) / 1e3 / n_fwd
    names = sorted({e["name"] for e in events})
    by_name: dict = {}
    for e in events:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    mflop = dave2_flops(cfg, 1) / 1e6
    print(f"[dave2] B=1 forward: {ms:.4f} ms back to back (CUDA events, 100 "
          f"calls), {g_ms:.4f} ms in a CUDA graph (device time), "
          f"{len(events) / n_fwd:g} device launches a forward ({busy_ms:.4f} "
          f"ms of them busy, torch.profiler, {len(names)} distinct kernels); "
          f"{mflop:.2f} MFLOP a frame [{smi}]")
    print("[dave2] B=1 top device events, ms a forward: " + "; ".join(
        f"{d / 1e3 / n_fwd:.4f} {n[:60]}" for n, d in top))
    roof = roofline_step("dave2", "B=1 forward", model, (x1,), ms,
                         "float32", 1, smi)
    roof["graph_ms"] = g_ms
    roof["graph_share"] = roof["bound_ms"] / g_ms
    if roof["flops"] != dave2_flops(cfg, 1):
        fail(f"dave2: the analysis counts {roof['flops']} FLOPs a B=1 "
             f"forward, the layer formula {dave2_flops(cfg, 1)}")
    print(f"[roofline] dave2 B=1 forward in a CUDA graph: {g_ms:.6g} ms, "
          f"{100 * roof['graph_share']:.2f}% of the bound; FLOPs equal the "
          f"layer formula's {dave2_flops(cfg, 1)} [{smi}]")
    return {"roofline": {"forward B=1": roof}, "max_abs_err": errs,
            "tol": DAVE2_TOL, "b1_ms": ms, "b1_graph_ms": g_ms,
            "launches_per_forward": len(events) / n_fwd,
            "b1_busy_ms": busy_ms, "kernels": names, "mflop_per_frame": mflop,
            "b1_top_ms": {n: d / 1e3 / n_fwd for n, d in top}}


def phase_fig1(dev, smi: str) -> dict:
    """(g) the port's Fig.1 benchmark; then one co-run traced, to show that
    the memory co-runner's kernels run beside the DNN's (streams of their
    own) rather than queue behind them."""
    rows = fig1.run(dev)
    for r in rows:
        print(f"[fig1] {r}")
    _, model = DV.make_dave2(DAVE2, device=dev)
    img = torch.ones((fig1.BATCH, *DAVE2.input_hw, DAVE2.in_channels),
                     device=dev)
    stream = torch.cuda.Stream()
    torch.cuda.synchronize()

    def dnn():
        with torch.cuda.stream(stream):
            model(img)

    def corun():
        with fig1.hammering(dev):
            fig1.time_fn(dnn, stream, iters=10)
    by_stream: dict = {}
    for e in device_events(corun, "fig1_corun"):
        by_stream.setdefault(e["stream"], []).append(e)
    if len(by_stream) < 2:
        fail(f"fig1: the co-run trace holds kernels on {len(by_stream)} "
             f"stream(s)")
    ov = fig1_trace.corun_overlap(by_stream)
    print(f"[fig1] co-run traced (torch.profiler): the DNN's "
          f"{ov['dnn_kernels']} kernels take {ov['dnn_kernel_ms']:.4f} ms, "
          f"{ov['overlap_ms']:.4f} ms of it ({ov['share']:.3f}) beside the "
          f"co-runner's {ov['other_kernels']} kernels "
          f"({ov['other_busy_ms']:.4f} ms busy, {ov['other_span_share']:.3f} "
          f"of the DNN's {ov['dnn_span_ms']:.4f} ms span) [{smi}]")
    if ov["overlap_ms"] <= 0:
        fail("fig1: the co-runner's kernels never ran beside the DNN's: "
             "the co-run measured queueing, not contention")
    return {"rows": rows, "overlap": ov}


def phase_fig6(dev, smi: str, dnn_kernels: list[str]) -> dict:
    """(h) the port's Fig.6 benchmark: Solo, Co-Sched and RT-Gang; then the
    DNN alone on the executor at its period, and each mode again under
    torch.profiler for the DNN's kernel time a quantum and its overlap with
    the best-effort kernels (the DNN's kernels are those of phase (f))."""
    rows = fig6.run(duration=FIG6_DURATION, device=dev)
    modes = ("solo",) + tuple(m for m, _, _ in fig6.MODES)
    for mode in modes:
        r = rows.get(mode, {})
        if not r.get("n"):
            fail(f"fig6 {mode}: no DNN quantum ran ({r})")
        print(f"[fig6] {mode}: p50 {r['p50_ms']} ms, p95 {r['p95_ms']} ms, "
              f"p99 {r['p99_ms']} ms, max {r['max_ms']} ms, n {r['n']}, "
              f"be_quanta {r.get('be_quanta', '-')}")
    for mode in modes:
        r = rows[mode]
        print(f"[fig6] {mode}: DNN quantum on its lane's stream (CUDA "
              f"events) p50 {r['dev_p50_ms']} ms, p99 {r['dev_p99_ms']} ms; "
              f"of the wall p50 / p99 {r['dev_p50_ms'] / r['p50_ms']:.3f} / "
              f"{r['dev_p99_ms'] / r['p99_ms']:.3f} [{smi}]")
    solo = rows["solo"]
    print(f"[fig6] against Solo (reported, not checked): p50 Co-Sched "
          f"{rows['cosched']['p50_ms'] / solo['p50_ms']:.3f}x, RT-Gang "
          f"{rows['rtgang']['p50_ms'] / solo['p50_ms']:.3f}x; p99 Co-Sched "
          f"{rows['cosched']['p99_ms'] / solo['p99_ms']:.3f}x, RT-Gang "
          f"{rows['rtgang']['p99_ms'] / solo['p99_ms']:.3f}x")

    bench = fig6.Fig6(dev)
    alone = bench.gang(True, 0.0, FIG6_DURATION, best_effort=False)
    print(f"[fig6] the DNN alone on the executor at its 20 ms period (no "
          f"best-effort job): p50 {alone['p50_ms']} ms, p99 "
          f"{alone['p99_ms']} ms, max {alone['max_ms']} ms, n {alone['n']}; "
          f"lane stream p50 {alone['dev_p50_ms']} ms [{smi}]")
    traced = {}
    for mode in modes:
        out = {}
        if mode == "solo":
            def go():
                out["row"] = bench.solo()
        else:
            enabled, budget = next((e, b) for m, e, b in fig6.MODES
                                   if m == mode)

            def go():
                out["row"] = bench.gang(enabled, budget, FIG6_TRACED_S)
        events = device_events(go, f"fig6_{mode}")
        if mode == "rtgang":
            rtgang_trace = bench.trace
        row = out["row"]
        n = row["n"]
        mine = [e for e in events if e["name"] in dnn_kernels]
        ov = fig1_trace.overlap(mine, [e for e in events
                            if e["name"] not in dnn_kernels])
        t = traced[mode] = dict(
            ov, n=n, dnn_busy_ms=ov["dnn_kernel_ms"] / n,
            dnn_launches=ov["dnn_kernels"] / n, wall_p50_ms=row["p50_ms"],
            stream_p50_ms=row["dev_p50_ms"])
        span = "100 calls" if mode == "solo" else f"{FIG6_TRACED_S} s"
        print(f"[fig6] {mode} traced ({span}, torch.profiler): a DNN "
              f"quantum's {t['dnn_launches']:g} device launches are busy "
              f"{t['dnn_busy_ms']:.4f} ms, "
              f"{ov['share']:.3f} of it beside other kernels "
              f"(busy {ov['other_busy_ms']:.3f} ms in {ov['other_kernels']}"
              f"); traced wall p50 {row['p50_ms']} ms, lane stream p50 "
              f"{row['dev_p50_ms']} ms; the DNN's busy time / untraced wall "
              f"p50 {t['dnn_busy_ms'] / rows[mode]['p50_ms']:.3f} [{smi}]")
    return dict(rows, alone=alone, traced=traced, trace=rtgang_trace)


def phase_vgang(dev, smi: str) -> dict:
    """(i) virtual gangs on the card: the port's executor vgang bench at
    its full default duration with --reclaim (solo, vgang, rtgT, rtgT+dr),
    its JSON under build/; then the fleet example plain, with
    --rtg-throttle and with --reclaim."""
    out = ROOT / "build" / "BENCH_executor_vgang_torch.json"
    out.parent.mkdir(exist_ok=True)
    rc = vbench.main(["--reclaim", "--out", str(out)])
    doc = json.loads(out.read_text())
    if rc or not doc["ok"]:
        fail(f"vgang bench: rc {rc}, failures {doc['failures']}")
    print(f"[vgang] {doc['device']}; lanes {doc['n_lanes']}, regulation "
          f"window {doc['interval_s'] * 1e3:g} ms, {doc['duration_s']:.3f} "
          f"s a mode, WCET margin {doc['margin']}, blocking "
          f"{doc['blocking_ms']:.3f} ms, periods {doc['periods_ms']}; "
          f"RTG-throttle bytes declared (not measured) [{smi}]")
    for name in vbench.MEMBERS:
        print(f"[vgang] {name}: calibrated quantum "
              f"{doc['quanta_ms'][name]:.4f} ms, WCET "
              f"{doc['wcet_ms'][name]:.4f} ms")
    for mode, row in doc["modes"].items():
        for name, e in row["members"].items():
            # the bench's own checks, held again here
            if not e["rta_ok"] or e["rta_bound_ms"] is None:
                fail(f"vgang {mode}:{name}: RTA verdict not ok")
            if not e["jobs"]:
                fail(f"vgang {mode}:{name}: no response recorded")
            if e["max_response_ms"] > e["rta_bound_ms"]:
                fail(f"vgang {mode}:{name}: max response "
                     f"{e['max_response_ms']} ms > bound "
                     f"{e['rta_bound_ms']} ms")
            print(f"[vgang] {mode} {name} ({e['vgang']}): jobs {e['jobs']}, "
                  f"first {e['first_response_ms']:.3f} ms, max "
                  f"{e['max_response_ms']:.3f} ms, bound "
                  f"{e['rta_bound_ms']:.3f} ms, worst margin "
                  f"{e['worst_margin_ms']:.3f} ms")
        if row["invariant_violations"] or row["budget_violations"]:
            fail(f"vgang {mode}: {row['invariant_violations']} invariant, "
                 f"{row['budget_violations']} budget-ordering violations")
        ov = row["device_overlap"]
        if ov["cross_pairs"]:
            fail(f"vgang {mode}: {ov['cross_pairs']} pairs of quanta of "
                 f"different vgangs overlap on the device "
                 f"({ov['cross_ms']:.4f} ms)")
        print(f"[vgang] {mode}: vgangs {row['vgangs']}, acquisitions "
              f"{row['acquisitions']}, preemptions {row['preemptions']}, "
              f"be_quanta {row['be_quanta']}, rt_stalls {row['rt_stalls']}, "
              f"reclaimed {row['reclaimed_bytes']:g} B; device (CUDA "
              f"events): {ov['quanta']} quanta, 0 cross-vgang overlaps, "
              f"same-vgang members side by side {ov['same_ms']:.4f} ms of "
              f"{ov['same_busy_ms']:.4f} ms busy ({ov['same_share']:.3f}, "
              f"{ov['same_pairs']} pairs) [{smi}]")
    fleet = []
    for flags in FLEET_RUNS:
        stats = vgang_fleet.main(flags + ["--duration", str(FLEET_DURATION)])
        jobs = {n: len(r) for n, r in stats["response_times"].items()}
        if not stats["invariant_ok"]:
            fail(f"vgang_fleet {flags}: the gang invariant broke")
        if set(jobs) != {"perception", "fusion", "planner"} or \
                not all(jobs.values()):
            fail(f"vgang_fleet {flags}: a member ran no job ({jobs})")
        worst = {n: max(r) * 1e3 for n, r in stats["response_times"].items()}
        fleet.append({"flags": flags, "jobs": jobs, "worst_ms": worst,
                      "acquisitions": stats["acquisitions"],
                      "preemptions": stats["preemptions"],
                      "be_quanta": stats["be_quanta"],
                      "rt_stalls": stats["rt_stalls"],
                      "reclaimed_bytes": stats["reclaimed_bytes"]})
    summary = {m: {k: v for k, v in row.items() if k != "device_quanta"}
               for m, row in doc["modes"].items()}
    return {"bench": dict(doc, modes=summary), "fleet": fleet}


def rta_shards():
    """(j)'s two shards as (name, C, P, prio) rows: the 500 seeded task sets
    of tests/test_batched_rta.py, and the grid's full default shard (4050
    sets) collapsed as its rtgang column analyzes them (singleton vgangs,
    priorities by rate, WCETs inflated by intensity interference)."""
    def draw(n_sets, seed, n_cores=4, max_tasks=8, max_util=2.2):
        out = []
        for k in range(n_sets):
            rng = random.Random(taskset_seed(seed, k, 1.0))
            n = rng.randint(1, max_tasks)
            out.append(random_gang_taskset(rng, n_cores, n,
                                           rng.uniform(0.1, max_util)))
        return out
    sets = draw(250, 0) + draw(150, 1, max_tasks=12, max_util=3.0) + \
        draw(100, 2, n_cores=8, max_util=1.5)
    rows = [[(t.name, t.wcet, t.period, t.prio) for t in ts] for ts in sets]
    grid = []
    for m in GRID_CORES:
        for dist in GRID_DISTS:
            for u in GRID_UTILS:
                for k in range(GRID_SETS):
                    tasks = random_vgang_taskset(
                        random.Random(taskset_seed(0, k, u)), m,
                        n_tasks_for(m), u, dist)
                    vgangs = assign_priorities(singleton_vgangs(tasks))
                    eq = VRTA.vgang_taskset(
                        vgangs, intensity_interference(tasks, 0.5))
                    grid.append([(t.name, t.wcet, t.period, t.prio)
                                 for t in eq])
    return rows, grid


def phase_rta(dev, smi: str) -> dict:
    """(j) the batched RTA's torch backend on the card (float64, lockstep
    over the whole shard) against the numpy backend, on the 500 seeded
    task sets and on the grid's full default shard: equal verdicts, the
    same lanes settled, finite WCRTs within a relative 1e-12; both
    backends' times (host clock, the torch call ends with its copy back)."""
    rows, grid = rta_shards()
    out = {}
    for label, shard, kw in (("500 sets", rows, {}),
                             ("500 sets, blocking 0.7, crpd 0.25", rows,
                              {"blocking": 0.7, "crpd": 0.25}),
                             ("grid 4050 sets", grid, {})):
        batch = BRTA.pad_rows(shard)
        t0 = time.perf_counter()
        a = BRTA.fixed_point(batch, backend="numpy", **kw)
        np_ms = (time.perf_counter() - t0) * 1e3
        times = []
        for _ in range(2):               # the first call, then again
            t0 = time.perf_counter()
            b = BRTA.fixed_point(batch, backend="torch", device=dev, **kw)
            times.append((time.perf_counter() - t0) * 1e3)
        same_nan = bool(np.array_equal(np.isnan(a), np.isnan(b)))
        fin = np.isfinite(a)
        rel = float(np.max(np.abs(b[fin] - a[fin]) / np.abs(a[fin]))) \
            if fin.any() else 0.0
        bits_a, bits_b = BRTA.accept_bits(batch, a), BRTA.accept_bits(batch, b)
        print(f"[rta] {label}: shape {batch.shape}, lanes settled "
              f"{int(fin.sum())} of {int(batch.valid.sum())}, accepted "
              f"{int(bits_a.sum())}; numpy {np_ms:.3f} ms, torch on {dev} "
              f"{times[0]:.3f} ms first, {times[1]:.3f} ms again; max rel "
              f"WCRT difference {rel:.3g}, exactly equal "
              f"{int((a[fin] == b[fin]).sum())} [{smi}]")
        if not same_nan or rel > RTA_RTOL or \
                not np.array_equal(bits_a, bits_b):
            fail(f"rta {label}: the torch backend disagrees with numpy "
                 f"(same lanes {same_nan}, max rel {rel}, verdicts equal "
                 f"{np.array_equal(bits_a, bits_b)})")
        out[label] = {"shape": list(batch.shape), "numpy_ms": np_ms,
                      "torch_ms": times, "max_rel": rel,
                      "settled": int(fin.sum()),
                      "accepted": int(bits_a.sum())}
    # the vgang entry point the grid calls, through the torch backend on
    # the card (its default device)
    work = []
    for k in range(GRID_SETS):
        tasks = random_vgang_taskset(random.Random(taskset_seed(0, k, 1.1)),
                                     16, n_tasks_for(16), 1.1, "mixed")
        work.append((assign_priorities(singleton_vgangs(tasks)),
                     intensity_interference(tasks, 0.5)))
    vs, intfs = [w[0] for w in work], [w[1] for w in work]
    got = VRTA.batched_accepts(vs, intfs, backend="torch")
    if got != VRTA.batched_accepts(vs, intfs, backend="numpy"):
        fail("rta: vgang batched_accepts differs between torch and numpy")
    return out


def curve_rows(out_dir: Path) -> tuple[dict, dict]:
    """{curve file: rows without their wall-clock fields} of a grid run,
    and its summary."""
    summary = json.loads((out_dir / "summary.json").read_text())
    return {Path(f).name: [
        {k: v for k, v in r.items() if not k.startswith("wall")}
        for r in json.loads((out_dir / Path(f).name).read_text())["rows"]]
        for f in summary["files"]}, summary


def phase_grid(dev, smi: str) -> dict:
    """(p) the port's virtual-gang grid on grid_smoke.json with the batched
    RTA on numpy and on the torch backend on the card (its cells in this
    process; its call counter must move), rows equal; then the port's
    schedulability sweep on sweep_smoke.json (RTA never accepts a set the
    exact simulation misses). Both write under build/; in one process,
    since a worker forked from this one could not use the card."""
    out = ROOT / "build"
    times, rows = {}, {}
    for backend in ("numpy", "torch"):
        calls = BRTA.torch_calls
        t0 = time.perf_counter()
        rc = grid.main(["--config", str(GRID_SMOKE), "--out",
                        str(out / f"vgang_smoke_{backend}"), "--backend",
                        backend, "--procs", "1"])
        times[backend] = time.perf_counter() - t0
        rows[backend], summary = curve_rows(out / f"vgang_smoke_{backend}")
        ran = BRTA.torch_calls - calls
        print(f"[grid] {GRID_SMOKE.name} on {backend}: rc {rc}, "
              f"{sum(map(len, rows[backend].values()))} rows, skipped cells "
              f"{summary['skipped_cells']}, soundness violations "
              f"{summary['soundness_violations']}, torch backend calls "
              f"{ran}, {times[backend]:.2f} s [{smi}]")
        if rc or summary["skipped_cells"]:
            fail(f"grid on {backend}: rc {rc}, skipped cells "
                 f"{summary['skipped_cells']}")
        if (ran > 0) != (backend == "torch"):
            fail(f"grid on {backend}: the torch backend ran {ran} times")
    if rows["numpy"] != rows["torch"]:
        fail("grid: the rows on the torch backend differ from numpy's")
    path = out / "sched_sweep_torch_smoke.json"
    sweep.main(["--config", str(SWEEP_SMOKE), "--out", str(path),
                "--procs", "1"])
    doc = json.loads(path.read_text())
    for r in doc["rows"]:
        if r["rta_sched_ratio"] > r["sim_sched_ratio"] or r["n"] != 10:
            fail(f"sweep: RTA accepts more than the simulation misses ({r})")
    print(f"[grid] sweep {SWEEP_SMOKE.name}: " + ", ".join(
        f"util {r['util']} sim {r['sim_sched_ratio']} rta "
        f"{r['rta_sched_ratio']}" for r in doc["rows"]) + f"; {path.name}")
    return {"rows_equal": True, "grid_s": times, "sweep": doc["rows"]}


def phase_perfetto(trace, smi: str) -> dict:
    """(q) the executor trace of (h)'s traced RT-Gang run as a Perfetto /
    Chrome trace under build/: fails on any message of
    validate_chrome_trace and unless the file's core tracks invert to the
    trace's labeled segments."""
    data = export_trace(trace, rt_names=["dnn"], title="fig6 rtgang")
    probs = validate_chrome_trace(data)
    if probs:
        fail(f"perfetto: {probs[:5]}")
    path = ROOT / "build" / "perfetto_fig6_rtgang.json"
    write_chrome_trace(str(path), data)
    got = segments_from_json(json.loads(path.read_text()))
    want = sorted(((sg.core, sg.label, sg.t0, sg.t1)
                   for sg in trace.segments if sg.label is not None),
                  key=lambda t: (t[0], t[2]))
    if got != want:
        fail(f"perfetto: the round trip gives {len(got)} segments, the "
             f"trace has {len(want)}, or they differ")
    cats: dict = {}
    for e in data["traceEvents"]:
        if e["ph"] == "X":
            cats[e["cat"]] = cats.get(e["cat"], 0) + 1
    print(f"[perfetto] fig6 RT-Gang executor trace: {len(got)} spans "
          f"{cats} over {trace.n_cores} lanes, valid, round trip exact; "
          f"{path.relative_to(ROOT)} ({path.stat().st_size} B) [{smi}]")
    return {"spans": len(got), "by_cat": cats, "path": str(path)}


def phase_roofline_check(dev, smi: str) -> dict:
    """(r) the cost analysis of one callable on the card and on the CPU:
    the reduced config of each family in f32 from the same weights (drawn
    on the card), a prefill of ROOF_SEQ tokens and a decode step after it,
    must give the same FLOPs and bytes on both (the kernels' work charged
    from their shapes on the card, their plain versions' ops inside the
    wrappers on the CPU)."""
    parallel = ParallelConfig(param_dtype="float32", compute_dtype="float32")
    out = {}
    for arch in SMOKE_ARCHS:
        cfg = reduced(get_config(arch))
        params = L.init_params(build_model(cfg, parallel, dev).defs, seed=1,
                               dtype=torch.float32, device=dev)
        batch = {"tokens": torch.as_tensor(np.random.default_rng(3).integers(
            0, cfg.vocab_size, size=(1, ROOF_SEQ)), device=dev),
            **stub_inputs(cfg, 3, dev)}
        side = {}
        for label, where in (("card", dev), ("cpu", torch.device("cpu"))):
            api = build_model(cfg, parallel, where)
            p = L.tree_map(lambda _, a: a.to(where), params)
            b = {k: v.to(where) for k, v in batch.items()}
            pre = analyze(api.prefill_fn, p, b)
            logits, c = api.prefill_fn(p, b)
            caches = batch_caches([c], [ROOF_SEQ], ROOF_MAX_SEQ)
            tok = logits[:, -1].argmax(-1, keepdim=True)
            dec = analyze(api.decode_fn, p, caches, tok,
                          torch.tensor([ROOF_SEQ], device=where))
            side[label] = {
                "prefill": {k: pre[k] for k in ("flops", "bytes")},
                "decode": {k: dec[k] for k in ("flops", "bytes")},
                "kernels": pre["kernels"]}
        print(f"[roofline] {arch} reduced f32, card vs CPU: prefill "
              f"{side['card']['prefill']} / {side['cpu']['prefill']}, decode "
              f"{side['card']['decode']} / {side['cpu']['decode']}; kernels "
              f"charged {side['card']['kernels']}")
        for step in ("prefill", "decode"):
            if side["card"][step] != side["cpu"][step]:
                fail(f"roofline {arch} {step}: the card counts "
                     f"{side['card'][step]}, the CPU {side['cpu'][step]}")
        if side["card"]["kernels"] != side["cpu"]["kernels"]:
            fail(f"roofline {arch}: kernels charged on the card "
                 f"{side['card']['kernels']}, on the CPU "
                 f"{side['cpu']['kernels']}")
        out[arch] = side
    return out


def phase_train_check(dev) -> dict:
    """One f32 loss + gradient at full width (2 layers, B=1, S=256), on
    the card and on the CPU from the same weights (drawn on the card):
    the loss within CHECK_LOSS_RTOL, each gradient leaf within
    CHECK_GRAD_TOL of its largest |g| on the CPU."""
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=CHECK_LAYERS,
                              dtype="float32")
    b = TokenSource(DataConfig(seq_len=CHECK_SEQ, global_batch=1,
                               vocab_size=cfg.vocab_size)).train_batch(0)
    rep = grads_card_vs_cpu(cfg, b, dev)
    print(f"[train] f32 check, {TRAIN_ARCH} full width {CHECK_LAYERS} "
          f"layers, B=1, S={CHECK_SEQ}: loss card {rep['loss_card']:.7f} / "
          f"CPU {rep['loss_cpu']:.7f} (relative {rep['loss_rel']:.3g}, "
          f"limit {CHECK_LOSS_RTOL}); worst gradient leaf "
          f"{rep['worst_grad_leaf']} at {rep['worst_grad_rel']:.3g} of its "
          f"largest |g| (limit {CHECK_GRAD_TOL}); CPU step "
          f"{rep['cpu_s']:.1f} s")
    return rep


def grads_card_vs_cpu(cfg, b, dev, what: str = "train f32 check") -> dict:
    """One f32 loss + gradient of ``cfg`` on the numpy batch ``b``, on the
    card and on the CPU from the same weights (drawn on the card from seed
    1): fails unless the loss agrees within CHECK_LOSS_RTOL and each
    gradient leaf within CHECK_GRAD_TOL of its largest |g| on the CPU.
    Without RoPE the key bias's gradient is zero in exact arithmetic
    (softmax ignores a shift that all keys share): both sides give
    rounding noise there, so those leaves are held, on either side, to
    ZERO_GRAD_TOL of the tree's largest |g| instead."""
    parallel = ParallelConfig(param_dtype="float32", compute_dtype="float32")
    api = build_model(cfg, parallel, dev)
    params = L.init_params(api.defs, seed=1, dtype=torch.float32,
                           device=dev)
    loss_card, _, g_card = loss_and_grads(
        api, params, {k: torch.from_numpy(v).to(dev) for k, v in b.items()})
    g_card = [g.cpu() for g in L.tree_leaves(g_card)]
    cpu_params = L.tree_map(lambda _, p: p.cpu(), params)
    del params
    t0 = time.perf_counter()
    loss_cpu, _, g_cpu = loss_and_grads(
        build_model(cfg, parallel, "cpu"), cpu_params,
        {k: torch.from_numpy(v) for k, v in b.items()})
    cpu_s = time.perf_counter() - t0
    loss_card, loss_cpu = float(loss_card), float(loss_cpu)
    names = []
    L.tree_map(lambda path, _: names.append("/".join(path)), g_cpu)
    rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    g_cpu = L.tree_leaves(g_cpu)
    zero = [cfg.rope_theta == 0 and n.endswith("/bk") for n in names]
    top = max(float(c.abs().max()) for c in g_cpu)
    noise = max([max(float(a.abs().max()), float(c.abs().max())) / top
                 for a, c, z in zip(g_card, g_cpu, zero) if z] or [0.0])
    worst = max((float((a - c).abs().max()) / max(float(c.abs().max()),
                                                   1e-30), path)
                for a, c, path, z in zip(g_card, g_cpu, names, zero)
                if not z)
    if not noise <= ZERO_GRAD_TOL:
        fail(f"{what}: a key bias's gradient reached {noise:.3g} of the "
             f"largest |g|; it is zero in exact arithmetic")
    if not rel <= CHECK_LOSS_RTOL:
        fail(f"{what}: loss card {loss_card} vs CPU {loss_cpu}")
    if not worst[0] <= CHECK_GRAD_TOL:
        fail(f"{what}: gradient {worst[1]} off by {worst[0]:.3g} of its "
             f"largest |g|")
    return {"loss_card": loss_card, "loss_cpu": loss_cpu, "loss_rel": rel,
            "worst_grad_rel": worst[0], "worst_grad_leaf": worst[1],
            "key_bias_noise": noise, "cpu_s": cpu_s}


def phase_smoke(dev, smi: str) -> dict:
    """(o): scripts/torch_smoke_one.py on the card for one arch of each
    family (a train step, a prefill and a decode step of the reduced
    config, all finite); then one f32 loss + gradient of reduced
    internvl2-1b and reduced whisper-base on the card and on the CPU from
    the same weights, at (k)'s tolerances, with no kernel launch."""
    spec = importlib.util.spec_from_file_location(
        "torch_smoke_one", ROOT / "scripts" / "torch_smoke_one.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    reset_launches()
    smoke = script.main(list(SMOKE_ARCHS))
    smoke_launches = read_launches()
    print(f"[smoke] scripts/torch_smoke_one.py on the card: "
          + ", ".join(f"{r['arch']} loss {r['loss']:.4f}" for r in smoke)
          + f"; launches {smoke_launches} [{smi}]")
    checks = {}
    for arch in (VLM_ARCH, AUDIO_ARCH):
        cfg = reduced(get_config(arch))
        b = TokenSource(DataConfig(
            seq_len=SMOKE_SEQ, global_batch=2, vocab_size=cfg.vocab_size,
            n_vision_tokens=cfg.n_vision_tokens, d_model=cfg.d_model,
            n_frames=cfg.n_encoder_frames if cfg.family == "audio" else 0)
        ).train_batch(0)
        reset_launches()
        rep = grads_card_vs_cpu(cfg, b, dev, f"{arch} f32 check")
        rep["launches"] = read_launches()
        stub = ", ".join(sorted(set(b) - {"tokens", "labels"}))
        print(f"[smoke] {arch} reduced, f32 loss + gradient, B=2, "
              f"S={SMOKE_SEQ} (with {stub}): "
              f"loss card {rep['loss_card']:.7f} / CPU {rep['loss_cpu']:.7f} "
              f"(relative {rep['loss_rel']:.3g}, limit {CHECK_LOSS_RTOL}); "
              f"worst gradient leaf {rep['worst_grad_leaf']} at "
              f"{rep['worst_grad_rel']:.3g} of its largest |g| (limit "
              f"{CHECK_GRAD_TOL}); key-bias gradient noise "
              f"{rep['key_bias_noise']:.3g} of the largest |g| (limit "
              f"{ZERO_GRAD_TOL}); launches {rep['launches']}")
        if any(rep["launches"].values()):
            fail(f"{arch}: the train path launched {rep['launches']}")
        checks[arch] = rep
    return {"smoke": smoke, "smoke_launches": smoke_launches,
            "f32_check": checks}


def phase_train_restart(dev) -> dict:
    """TrainRunner at reduced size under build/: a run that fails at step
    10 and resumes from its step-8 checkpoint against one that does not
    fail; every step's loss within RESTART_RTOL."""
    cfg = reduced(get_config(TRAIN_ARCH))
    parallel = ParallelConfig(param_dtype="float32", compute_dtype="float32",
                              q_block=64, kv_block=64)
    api = build_model(cfg, parallel, dev)
    opt = Optimizer(OptConfig(lr=3e-3, warmup=2, decay_steps=20))
    data = DataConfig(seq_len=32, global_batch=4, vocab_size=cfg.vocab_size)
    base = ROOT / "build" / "train_restart"
    shutil.rmtree(base, ignore_errors=True)

    def runner(name, fail_at=None):
        return TrainRunner(api, opt, data, RunnerConfig(
            total_steps=12, ckpt_every=4, ckpt_dir=str(base / name),
            fail_at_step=fail_at))
    clean = runner("clean")
    clean.run()
    want = {m["step"]: m["loss"] for m in clean.metrics_log}
    first = runner("ft", fail_at=10)
    try:
        first.run()
        fail("train restart: the injected failure did not raise")
    except SimulatedFailure:
        pass
    second = runner("ft")
    second.run()
    got = first.metrics_log + second.metrics_log
    steps = [m["step"] for m in got]
    if steps != list(range(10)) + [8, 9, 10, 11]:
        fail(f"train restart: steps {steps}")
    rel = max(abs(m["loss"] - want[m["step"]]) / abs(want[m["step"]])
              for m in got)
    print(f"[train] restart at reduced size: failed at step 10, resumed "
          f"from the step-8 checkpoint; losses vs the uninterrupted run: "
          f"max relative difference {rel:.3g} (limit {RESTART_RTOL}); "
          f"loss {want[0]:.4f} -> {want[11]:.4f}")
    if not rel <= RESTART_RTOL:
        fail(f"train restart: losses differ by {rel:.3g} relative")
    shutil.rmtree(base, ignore_errors=True)
    return {"max_rel": rel, "losses": [want[i] for i in range(12)]}


def phase_train(dev, smi: str) -> dict:
    """(k): qwen2-7b at full width (depth 28 -> 8) through TrainRunner,
    bf16 compute / f32 masters, AdamW, remat "block", B=4, S=1024, 30
    steps; then the f32 card-vs-CPU step and the restart path."""
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TRAIN_LAYERS)
    parallel = ParallelConfig(param_dtype="float32",
                              compute_dtype="bfloat16", remat="block")
    api = build_model(cfg, parallel, dev)
    n = api.n_params()
    opt = Optimizer(OptConfig(name="adamw", lr=1e-3, warmup=5,
                              decay_steps=TRAIN_STEPS))
    data = DataConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                      vocab_size=cfg.vocab_size)
    runner = TrainRunner(api, opt, data, RunnerConfig(
        total_steps=TRAIN_STEPS, ckpt_every=TRAIN_STEPS + 1,
        ckpt_dir=str(ROOT / "build" / "train_full_width")))
    print(f"[train] {TRAIN_ARCH} full width (d_model {cfg.d_model}, d_ff "
          f"{cfg.d_ff}, {cfg.n_heads}/{cfg.n_kv_heads} heads, vocab "
          f"{cfg.vocab_size}), depth cut {get_config(TRAIN_ARCH).n_layers} "
          f"-> {TRAIN_LAYERS} layers: {n / 1e9:.3f} B params, f32 masters, "
          f"bf16 compute, AdamW, remat block, B={TRAIN_BATCH}, "
          f"S={TRAIN_SEQ}, {TRAIN_STEPS} steps, no checkpoint")
    t0 = time.perf_counter()
    state = runner.init_state(seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    state = runner.run(state, 0)
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log = runner.metrics_log
    losses = [m["loss"] for m in log]
    step_s = float(np.median([m["dur_s"] for m in log[TRAIN_SKIP:]]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    # the input table is a lookup and does no matrix product: N leaves it
    # out (the tied table is the lm_head's, and stays)
    n_mm = n - (0 if cfg.tie_embeddings else cfg.vocab_size * cfg.d_model)
    mfu = 6 * n_mm * tokens / step_s / PEAK_OPS[torch.bfloat16]
    mfu_all = 6 * n * tokens / step_s / PEAK_OPS[torch.bfloat16]
    print(f"[train] step median {step_s * 1e3:.1f} ms (steps {TRAIN_SKIP}-"
          f"{TRAIN_STEPS - 1}; first {log[0]['dur_s'] * 1e3:.1f} ms), "
          f"{tokens / step_s:.0f} tokens/s, 6 N tokens / step with N = "
          f"{n_mm / 1e9:.3f} B (no input table) "
          f"{6 * n_mm * tokens / step_s / 1e12:.1f} TFLOP/s = {mfu:.3f} of "
          f"989 TFLOP/s bf16 ({mfu_all:.3f} with all {n / 1e9:.3f} B); "
          f"peak memory {peak_gb:.3f} GB; state drawn in "
          f"{init_s:.1f} s; loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"launches {launches}; stragglers {len(runner.straggler_steps)} "
          f"[{smi}]")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"train: losses {losses} are not finite or did not fall")
    if any(launches.values()):
        fail(f"train: the train path launched {launches}; JAX's training "
             f"reaches no Pallas kernel")
    trace = trace_train_step(runner, state, smi)
    del state, runner
    gc.collect()
    torch.cuda.empty_cache()
    check = phase_train_check(dev)
    restart = phase_train_restart(dev)
    return {"launches": launches, "n_params": n, "step_ms": step_s * 1e3,
            "first_step_ms": log[0]["dur_s"] * 1e3,
            "step_ms_all": [m["dur_s"] * 1e3 for m in log],
            "tokens_per_s": tokens / step_s, "n_matmul_params": n_mm,
            "mfu": mfu, "mfu_all_params": mfu_all, "peak_gb": peak_gb,
            "losses": losses, "init_s": init_s, "trace": trace,
            "f32_check": check, "restart": restart}


def trace_train_step(runner, state, smi: str, top: int = 8) -> dict:
    """One more step of (k) under torch.profiler: the device's busy time
    (the traced device events' durations summed: one stream), its idle
    share of the step and the kernels that take the most device time."""
    step, batch = next(runner.loader.iterate(TRAIN_STEPS))
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, metrics = runner.step_fn(state, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in events) / 1e3
    by_name: dict[str, list[float]] = {}
    for e in events:
        by_name.setdefault(e.name, []).append(e.device_time_total / 1e3)
    kernels = sorted(((sum(ts), len(ts), n) for n, ts in by_name.items()),
                     reverse=True)[:top]
    print(f"[train] step {step} traced: wall {wall_ms:.1f} ms (profiler "
          f"on), device busy {busy_ms:.1f} ms in {len(events)} device "
          f"events, idle share {1 - busy_ms / wall_ms:.3f} [{smi}]")
    for ms, n, name in kernels:
        print(f"[train]   {ms:8.2f} ms in {n:5d} launches: {name[:100]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms, "events": len(events),
            "top": [{"ms": ms, "launches": n, "name": name}
                    for ms, n, name in kernels]}


def stream_overlap(intervals: list[dict], name: str, other: str) -> dict:
    """How much of ``name``'s stream time (CUDA events on its lane's
    stream) ran beside ``other``'s: ``overlap`` on the intervals in µs."""
    def events(n):
        return [{"ts": q["start_ms"] * 1e3,
                 "dur": (q["end_ms"] - q["start_ms"]) * 1e3}
                for q in intervals if q["name"] == n]
    ov = fig1_trace.overlap(events(name), events(other))
    return {"stream_ms": ov["dnn_kernel_ms"], "overlap_ms": ov["overlap_ms"],
            "share": ov["share"]}


def phase_serve_train(dev, smi: str) -> dict:
    """(l): examples/serve_with_background_training.run at full width,
    SERVE_TRAIN_DURATION s in each of SERVE_TRAIN_MODES: RT-Gang with the
    example's declared cost, RT-Gang with one within the budget, and
    Co-Sched."""
    serve_cfg = get_config("qwen2-7b")
    train_cfg = dataclasses.replace(get_config("olmoe-1b-7b"),
                                    n_layers=BE_TRAIN_LAYERS)
    t0 = time.perf_counter()
    models = swbt.build(
        serve_cfg, train_cfg, device=dev,
        serve_parallel=ParallelConfig(param_dtype="bfloat16",
                                      compute_dtype="bfloat16"),
        train_parallel=ParallelConfig(param_dtype="float32",
                                      compute_dtype="bfloat16"))
    print(f"[serve+train] RT: qwen2-7b bf16, {serve_cfg.n_layers} layers; "
          f"BE: olmoe-1b-7b full width, depth cut "
          f"{get_config('olmoe-1b-7b').n_layers} -> {BE_TRAIN_LAYERS}, "
          f"{models['train_api'].n_params() / 1e9:.3f} B params, f32 "
          f"masters, bf16 compute, AdamW, 4 x 64 tokens a microstep; built "
          f"in {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    rows = {}
    for mode, enabled, train_bytes in SERVE_TRAIN_MODES:
        reset_launches()
        res = swbt.run(models, enabled=enabled,
                       duration=SERVE_TRAIN_DURATION,
                       train_bytes=train_bytes,
                       log=lambda line: print(f"{line} [{smi}]"))
        launches = read_launches()
        flash_paths = check_flash_paths(f"serve+train {mode}",
                                        launches["flash_attention"], smi)
        expect = {"flash_attention": serve_cfg.n_layers * res["prefills"],
                  "moe_gmm": 0, "ssd_scan": 0, "rglru_scan": 0,
                  "ssm_glue": 0}
        q, r, t = res["decode_ms"], res["response_ms"], res["train_ms"]
        busy = res["busy_ms"]
        ov = stream_overlap(res["intervals"], "serve-decode", "train-be")
        rows[mode] = row = {
            "decode_quanta": int(len(q)),
            "quantum_p50_ms": float(np.percentile(q, 50)) if len(q) else None,
            "quantum_p99_ms": float(np.percentile(q, 99)) if len(q) else None,
            "quantum_max_ms": float(q.max()) if len(q) else None,
            "response_p50_ms": float(np.percentile(r, 50)) if len(r) else None,
            "response_p99_ms": float(np.percentile(r, 99)) if len(r) else None,
            "response_max_ms": float(r.max()) if len(r) else None,
            "busy_quanta": int(len(busy)),
            "busy_p50_ms": float(np.percentile(busy, 50)) if len(busy)
            else None,
            "busy_p99_ms": float(np.percentile(busy, 99)) if len(busy)
            else None,
            "requests_done": sum(x.done for x in res["requests"]),
            "prefills": res["prefills"], "microsteps": int(len(t)),
            "train_bytes": train_bytes,
            "microstep_p50_ms": float(np.median(t)) if len(t) else None,
            "warmup_loss": res["warmup_loss"], "losses": res["losses"],
            "be_quanta": res["stats"]["be_quanta"],
            "decode_overlap": ov, "launches": launches,
            "flash_paths": flash_paths}
        print(f"[serve+train] {mode} (train declared {train_bytes:g} B a "
              f"quantum): decode quantum p50 / p99 / max "
              f"{row['quantum_p50_ms']} / {row['quantum_p99_ms']} / "
              f"{row['quantum_max_ms']} ms over {len(q)} quanta; busy "
              f"quanta (refill + decode) p50 / p99 {row['busy_p50_ms']} / "
              f"{row['busy_p99_ms']} ms over {len(busy)}; response "
              f"p50 / p99 / max {row['response_p50_ms']} / "
              f"{row['response_p99_ms']} / {row['response_max_ms']} ms; "
              f"requests done {row['requests_done']}/8; train microsteps "
              f"{len(t)} (median {row['microstep_p50_ms']} ms) after the "
              f"warm-up's; be_quanta {row['be_quanta']}; decode stream time "
              f"beside a microstep {ov['overlap_ms']:.3f} of "
              f"{ov['stream_ms']:.3f} ms ({ov['share']:.3f}); launches "
              f"{launches} (expected {expect}) [{smi}]")
        if not len(q):
            fail(f"serve+train {mode}: no decode quantum ran")
        if not all(np.isfinite([res["warmup_loss"]] + res["losses"])):
            fail(f"serve+train {mode}: a non-finite loss")
        if launches != expect:
            fail(f"serve+train {mode}: launches {launches}, expected "
                 f"{expect}")
    # RT-Gang's regime (the example's 5e5 B budget against 1e6 B declared
    # a microstep) admits no microstep once the gang has led: training's
    # progress there is its warm-up microstep, as in JAX's example. Under
    # a declared cost within the budget, RT-Gang must train too
    for mode in ("rtgang_fit", "cosched"):
        if not rows[mode]["microsteps"]:
            fail(f"serve+train {mode}: no train microstep ran")
    rows["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"[serve+train] peak memory {rows['peak_gb']:.3f} GB; decode "
          f"quantum p99 RT-Gang {rows['rtgang']['quantum_p99_ms']} ms, "
          f"RT-Gang with training admitted "
          f"{rows['rtgang_fit']['quantum_p99_ms']} ms, Co-Sched "
          f"{rows['cosched']['quantum_p99_ms']} ms (reported, not checked) "
          f"[{smi}]")
    del models
    return rows


def roofline_table(*reps) -> dict:
    """(r)'s rows of the gang phases and DAVE-2 by model and step, and a
    summary line each: the bound against the measured time."""
    names = ("qwen2-7b", "olmoe-1b-7b", GRANITE_ARCH, MINITRON_ARCH,
             MAMBA_ARCH, HYBRID_ARCH, VLM_ARCH, AUDIO_ARCH, "dave2")
    table = {}
    for name, rep in zip(names, reps):
        for step, r in rep["roofline"].items():
            table[f"{name} {step}"] = r
            print(f"[roofline] {name} {step}: bound {r['bound_ms']:.6g} ms "
                  f"({r['bound_by']}), measured {r['measured_ms']:.6g} ms, "
                  f"{100 * r['share']:.2f}% of the bound [{r['nvidia_smi']}]")
    return table


def check_hopper(built, kernel: str, n: int) -> dict:
    """A Hopper path of ``built``: its ``n`` instantiations of ``kernel``,
    each with products on wgmma (HGMMA) and operands through TMA (UTMALDG)
    in its SASS (cuobjdump -sass), and no wgmma that ptxas serialised (its
    warning C7518 in the nvcc log); spills are checked with the others.
    Returns the SASS counts by mangled name."""
    serialised = [line for line in built.log.splitlines() if "C7518" in line]
    if serialised:
        fail(f"ptxas serialised wgmma in {built.path.name}: " +
             "; ".join(serialised[:4]))
    counts = sass_counts(built.path, kernel, ("HGMMA", "UTMALDG", "UTMASTG"))
    for name, c in counts.items():
        print(f"[build] {kernel} {name} SASS (cuobjdump -sass): {c}")
        if not (c["HGMMA"] and c["UTMALDG"]):
            fail(f"{name}'s SASS lacks HGMMA or UTMALDG: {c}")
    if len(counts) != n:
        fail(f"{built.path.name} holds {len(counts)} {kernel} kernels, not "
             f"{n}")
    return counts


def kernel_entry(name, source, replaces, launches, rep) -> dict:
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(launches.values()),
            "launches_by_path": launches, "max_abs_err": rep["max_abs_err"],
            "ms": rep["ms"], "plain_ms": rep["plain_ms"],
            "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
            "library_ms": rep["library_ms"],
            "graph_ms": rep.get("graph_ms")}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this check "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {kind}; nvidia-smi: {smi}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # torch.compile (FlexAttention, (c5)'s library time) keeps its caches
    # in the checkout's build/ and compiles in this process: no worker pool
    for var, val in (("TORCHINDUCTOR_CACHE_DIR", ROOT / "build" / "inductor"),
                     ("TRITON_CACHE_DIR", ROOT / "build" / "triton"),
                     ("TORCHINDUCTOR_COMPILE_THREADS", 1)):
        os.environ.setdefault(var, str(val))

    with ThreadPoolExecutor(len(KERNELS)) as pool:   # one nvcc per source
        builds = dict(zip(KERNELS, pool.map(lambda m: m.build(),
                                            KERNELS.values())))
    build_report = {}
    for name, built in builds.items():
        print(f"[build] {name}: nvcc {built.seconds:.1f} s -> "
              f"{built.path.relative_to(ROOT)}")
        build_report[name] = ptxas_report(built.log)
        for k in build_report[name]:
            print(f"[build]   {k['kernel']}: {k['registers']} registers, "
                  f"{k['static_smem']} B static shared memory, spills "
                  f"{k['spill_stores']} B stored / {k['spill_loads']} B "
                  f"loaded")
            if (re.search(r"_(tc|wgmma|tf32x3)[<I]", k["kernel"]) or
                    name in ("ssd_scan", "rglru_scan", "ssm_glue")) and \
                    k["spill_stores"] + k["spill_loads"]:
                fail(f"kernel {k['kernel']} spills registers")
    fa_smem = {f"{p} D={d}": fa.smem_bytes(p, d) for p in fa.PATHS
               for d in fa.HEAD_DIMS}
    print("[build] dynamic shared memory a block, flash_attention: " +
          ", ".join(f"{k} {n} B" for k, n in fa_smem.items() if n >= 0))
    # flash's bf16 path at D >= 64: D 64, 128, 256, each with and without
    # a cap
    build_report["flash_wgmma_sass"] = check_hopper(
        builds["flash_attention"], "flash_fwd_wgmma", 6)
    # flash's f32 path at D >= 64 (split TF32): D 64, 128, 256, each with
    # and without a cap
    for k in build_report["flash_attention"]:
        if k["kernel"].startswith("flash_fwd_tf32x3"):
            d = int(re.search(r"<(\d+)", k["kernel"]).group(1))
            print(f"[build] flash_attention {k['kernel']}: {k['registers']} "
                  f"registers, {fa.smem_bytes('tf32x3', d)} B dynamic shared "
                  f"memory, spills {k['spill_stores']} / {k['spill_loads']} "
                  f"B")
    build_report["flash_tf32x3_sass"] = check_hopper(
        builds["flash_attention"], "flash_fwd_tf32x3", 6)
    print("[build] dynamic shared memory a block, moe_gmm: " + ", ".join(
        f"{p} C={c} {gmm.smem_bytes(p, c)} B" for p, c in (
            ("fma", 160), ("swap", 8), ("swap", 16), ("fill", 8),
            ("fill", 160), ("wgmma", 160), ("tf32x3", 8), ("tf32x3", 16),
            ("tf32x3", 48), ("tf32x3", 160))))
    # moe_gmm's prefill path: one instantiation without clusters, one with
    wg_kernels = [k for k in build_report["moe_gmm"]
                  if k["kernel"].startswith("gmm_wgmma")]
    if not wg_kernels:
        fail("moe_gmm's library holds no gmm_wgmma kernel")
    for k in wg_kernels:
        print(f"[build] moe_gmm {k['kernel']}: {k['registers']} registers, "
              f"{gmm.smem_bytes('wgmma', 160)} B dynamic shared memory, "
              f"spills {k['spill_stores']} / {k['spill_loads']} B")
    build_report["moe_gmm_wgmma_sass"] = check_hopper(
        builds["moe_gmm"], "gmm_wgmma", 2)
    # moe_gmm's decode path: 8 and 16 token rows a tile
    for k in build_report["moe_gmm"]:
        if k["kernel"].startswith("gmm_swap_wgmma"):
            c = 8 if "<8>" in k["kernel"] else 16
            print(f"[build] moe_gmm {k['kernel']}: {k['registers']} "
                  f"registers, {gmm.smem_bytes('swap', c)} B dynamic shared "
                  f"memory, spills {k['spill_stores']} / "
                  f"{k['spill_loads']} B")
    build_report["moe_gmm_swap_sass"] = check_hopper(
        builds["moe_gmm"], "gmm_swap_wgmma", 2)
    # moe_gmm's f32 path (split TF32): 8, 16, 64 and 128 token rows a tile
    for k in build_report["moe_gmm"]:
        if k["kernel"].startswith("gmm_tf32x3"):
            c = int(re.search(r"<(\d+)", k["kernel"]).group(1))
            print(f"[build] moe_gmm {k['kernel']}: {k['registers']} "
                  f"registers, {gmm.smem_bytes('tf32x3', c)} B dynamic "
                  f"shared memory, spills {k['spill_stores']} / "
                  f"{k['spill_loads']} B")
    build_report["moe_gmm_tf32x3_sass"] = check_hopper(
        builds["moe_gmm"], "gmm_tf32x3", 4)
    # ssd_scan: C B^T (ssd_cb) and the chunk-parallel scan (ssd_chunk), each
    # in f32 and bf16, products on wgmma in split TF32
    for k in build_report["ssd_scan"]:
        # by substring, as check_hopper matches: names stay mangled where
        # c++filt is missing
        name = next(n for n in ssd.KERNELS if n in k["kernel"])
        print(f"[build] ssd_scan {k['kernel']}: {k['registers']} registers, "
              f"{ssd.smem_bytes(name)} B dynamic shared memory, spills "
              f"{k['spill_stores']} / {k['spill_loads']} B")
    for name in ssd.KERNELS:
        build_report[f"{name}_sass"] = check_hopper(builds["ssd_scan"], name,
                                                    2)
    phase_s = {}

    def timed(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        phase_s[name] = time.perf_counter() - t0
        print(f"[time] phase {name}: {phase_s[name]:.1f} s")
        return out

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    rows = timed("c", phase_kernel, dev, smi)
    softcap_rows = timed("c5", phase_softcap, dev, smi)
    gmm_rows = timed("c2", phase_gmm, dev, smi)
    ssd_rows = timed("c3", phase_ssd, dev, smi)
    rg_rows = timed("c4", phase_rglru, dev, smi)
    glue_rows = timed("c6", phase_glue, dev, smi)
    cp_rep = timed("s", phase_cp, dev, smi)
    ep_rep = timed("t", phase_ep, dev, smi)
    sv = timed("d", phase_serving, dev, smi, "qwen2-7b", duration=6.0)
    timed("e", phase_oracle, dev, sv.pop("api"), sv.pop("params"))
    free()                                        # qwen2-7b's weights go
    sv2 = timed("d2", phase_serving, dev, smi, "olmoe-1b-7b", duration=12.0)
    sv2["plain_path_err"] = timed("e2", phase_oracle, dev, sv2.pop("api"),
                                  sv2.pop("params"))
    free()                                        # olmoe's weights go
    sv7 = timed("d5", phase_serving, dev, smi, GRANITE_ARCH, duration=16.0)
    sv7["plain_path_err"] = timed(
        "e5", phase_oracle, dev, sv7.pop("api"), sv7.pop("params"),
        n_layers=GRANITE_ORACLE_LAYERS, plain_path=True)
    free()                                        # granite's weights go
    sv8 = timed("d6", phase_serving, dev, smi, MINITRON_ARCH, duration=8.0)
    sv8["plain_path_err"] = timed("e6", phase_oracle, dev, sv8.pop("api"),
                                  sv8.pop("params"), plain_path=True)
    free()                                        # minitron's weights go
    softcap_model = timed("x", phase_softcap_model, dev, smi)
    free()
    sv3 = timed("d3", phase_gang, dev, smi, MAMBA_ARCH, duration=6.0,
                max_seq=0)
    sv3.update(timed("e3", phase_gang_oracle, dev, sv3.pop("api"),
                     sv3.pop("params"), max_seq=0))
    free()                                        # mamba2's weights go
    sv4 = timed("d4", phase_gang, dev, smi, HYBRID_ARCH, duration=6.0,
                max_seq=HYBRID_MAX_SEQ)
    sv4.update(timed("e4", phase_gang_oracle, dev, sv4.pop("api"),
                     sv4.pop("params"), max_seq=HYBRID_MAX_SEQ))
    free()                                        # recurrentgemma's go
    sv5 = timed("m", phase_gang, dev, smi, VLM_ARCH, duration=6.0,
                max_seq=VLM_MAX_SEQ, prompt_lens=VLM_PROMPTS)
    sv5.update(timed("m2", phase_gang_oracle, dev, sv5.pop("api"),
                     sv5.pop("params"), max_seq=VLM_MAX_SEQ,
                     prompt_lens=VLM_PROMPTS))
    free()                                        # internvl2's weights go
    sv6 = timed("n", phase_gang, dev, smi, AUDIO_ARCH, duration=6.0,
                max_seq=AUDIO_MAX_SEQ, prompt_lens=AUDIO_PROMPTS)
    sv6.update(timed("n2", phase_gang_oracle, dev, sv6.pop("api"),
                     sv6.pop("params"), max_seq=AUDIO_MAX_SEQ,
                     prompt_lens=AUDIO_PROMPTS))
    free()                                        # whisper's weights go
    reset_launches()                              # DAVE-2 runs no kernel
    dave2 = timed("f", phase_dave2, dev, smi)
    fig1_rep = timed("g", phase_fig1, dev, smi)
    fig6_rep = timed("h", phase_fig6, dev, smi, dave2["kernels"])
    if any(read_launches().values()):
        fail(f"phases (f)-(h) launched {read_launches()}: DAVE-2's path "
             f"has none of the four kernels")
    perfetto_rep = timed("q", phase_perfetto, fig6_rep.pop("trace"), smi)
    vgang_rep = timed("i", phase_vgang, dev, smi)
    if any(read_launches().values()):
        fail(f"phase (i) launched {read_launches()}: the vgang path has "
             f"none of the four kernels")
    rta_rep = timed("j", phase_rta, dev, smi)
    if any(read_launches().values()):
        fail(f"phase (j) launched {read_launches()}")
    grid_rep = timed("p", phase_grid, dev, smi)
    if any(read_launches().values()):
        fail(f"phase (p) launched {read_launches()}")
    train_rep = timed("k", phase_train, dev, smi)
    free()
    st_rep = timed("l", phase_serve_train, dev, smi)
    free()
    smoke_rep = timed("o", phase_smoke, dev, smi)
    roof_check = timed("r", phase_roofline_check, dev, smi)
    before = read_launches()
    dry_rep = timed("u", phase_dryrun, smi)
    if read_launches() != before:
        fail(f"phase (u) launched {read_launches()}: the dry run traces")
    bench_rep = timed("w", phase_bench_run, smi)
    free()
    mesh_rep = timed("v", phase_mesh, dev, smi)

    reported = {
        "flash_attention": next(r for r in rows if r.get("reported")),
        "moe_gmm": next(r for r in gmm_rows if r.get("reported")),
        "ssd_scan": next(r for r in ssd_rows if r.get("reported")),
        "rglru_scan": next(r for r in rg_rows if r.get("reported")),
        "ssm_conv_act": next(r for r in glue_rows if r.get("reported") and
                             r["kernel"] == "ssm_conv_act"),
        "ssm_gate_norm": next(r for r in glue_rows if r.get("reported") and
                              r["kernel"] == "ssm_gate_norm")}
    serve_train = {k: sum(st_rep[m]["launches"][k]
                          for m, _, _ in SERVE_TRAIN_MODES) for k in KERNELS}
    by_path = {"qwen2-7b": sv["launches"], "olmoe-1b-7b": sv2["launches"],
               GRANITE_ARCH: sv7["launches"], MINITRON_ARCH: sv8["launches"],
               "qwen2-7b softcap (x)": softcap_model["launches"],
               MAMBA_ARCH: sv3["launches"], HYBRID_ARCH: sv4["launches"],
               VLM_ARCH: sv5["launches"], AUDIO_ARCH: sv6["launches"],
               "train (k)": train_rep["launches"],
               "serve+train (l)": serve_train,
               "cp ranks (s)": {k: cp_rep["launches"] if k ==
                                "flash_attention" else 0 for k in KERNELS},
               "expert parallel (t)": {k: ep_rep["launches"] if k ==
                                       "moe_gmm" else 0 for k in KERNELS},
               "mesh (v)": mesh_rep["launches"]}
    replaces = {
        "flash_attention":
            "src/repro/kernels/flash_attention/flash_attention.py:82",
        "moe_gmm": "src/repro/kernels/moe_gmm/moe_gmm.py:51",
        "ssd_scan": "src/repro/kernels/ssd_scan/ssd_scan.py:74",
        "rglru_scan": "src/repro/kernels/rglru_scan/rglru_scan.py:55"}
    kernels = [kernel_entry(name, f"src/repro_torch/csrc/{name}.cu",
                            replaces[name],
                            {p: n[name] for p, n in by_path.items()},
                            reported[name]) for name in replaces]
    # the glue's launches, one of each kernel a Mamba2 layer's prefill; no
    # TPU kernel: XLA fuses the JAX package's glue
    kernels += [kernel_entry(name, "src/repro_torch/csrc/ssm_glue.cu",
                             "none (src/repro/models/mamba2.py, fused by "
                             "XLA)", {p: n["ssm_glue"] // 2
                                      for p, n in by_path.items()},
                             reported[name])
                for name in ("ssm_conv_act", "ssm_gate_norm")]
    # flash's launches on the serve and gang runs by kernel path
    runs = [sv, sv2, sv7, sv8, sv3, sv4, sv5, sv6] + \
        [st_rep[m] for m, _, _ in SERVE_TRAIN_MODES]
    kernels[list(KERNELS).index("flash_attention")]["kernel_paths"] = {
        p: sum(r["flash_paths"][p] for r in runs) for p in fa.PATHS}
    detail = {"device": kind, "nvidia_smi": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda,
              "build_s": {n: b.seconds for n, b in builds.items()},
              "ptxas": build_report,
              "kernel_rows": rows, "softcap_rows": softcap_rows,
              "gmm_rows": gmm_rows,
              "ssd_rows": ssd_rows, "rglru_rows": rg_rows,
              "glue_rows": glue_rows,
              "reported_cases": {n: r["case"] for n, r in reported.items()},
              "serve": sv, "serve_olmoe": sv2, "serve_granite": sv7,
              "serve_minitron": sv8, "softcap_model": softcap_model,
              "bench_run": bench_rep, "gang_mamba2": sv3,
              "gang_recurrentgemma": sv4, "gang_internvl2": sv5,
              "gang_whisper": sv6, "dave2": dave2, "fig1": fig1_rep,
              "fig6": fig6_rep, "perfetto": perfetto_rep, "vgang": vgang_rep,
              "rta": rta_rep, "grid": grid_rep,
              "roofline": roofline_table(sv, sv2, sv7, sv8, sv3, sv4, sv5,
                                         sv6, dave2),
              "roofline_card_vs_cpu": roof_check,
              "train": train_rep, "serve_train": st_rep, "smoke": smoke_rep,
              "cp": cp_rep, "ep": ep_rep, "dryrun": dry_rep,
              "mesh": mesh_rep,
              "phase_s": phase_s,
              "wall_s": time.perf_counter() - t_start}
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(detail, indent=1))
    print(f"kernels: [flash_attention: pass ({len(rows)} shapes, "
          f"{len(softcap_rows)} softcap cases), moe_gmm: "
          f"pass ({len(gmm_rows)} shapes), ssd_scan: pass ({len(ssd_rows)} "
          f"shapes), rglru_scan: pass ({len(rg_rows)} shapes), ssm_glue: "
          f"pass ({len(glue_rows)} kernel shapes)]; "
          f"{GRANITE_ARCH} and {MINITRON_ARCH} serving: pass (peak "
          f"{sv7['peak_gb']:.1f} / {sv8['peak_gb']:.1f} GB); softcapped "
          f"model: pass; {VLM_ARCH} and {AUDIO_ARCH} gangs: pass; dave2: "
          f"pass (card vs CPU, B {DAVE2_BATCHES}); fig1: "
          f"{len(fig1_rep['rows'])} rows; fig6: solo / cosched / rtgang n "
          f"{[fig6_rep[m]['n'] for m in ('solo', 'cosched', 'rtgang')]}; "
          f"vgang: pass ({len(vgang_rep['bench']['modes'])} modes, "
          f"{len(vgang_rep['fleet'])} fleet runs); rta: pass "
          f"({len(rta_rep)} shards); train: pass (loss "
          f"{train_rep['losses'][0]:.3f} -> {train_rep['losses'][-1]:.3f}, "
          f"f32 card vs CPU, restart); serve+train: pass (RT-Gang, "
          f"RT-Gang with training admitted, Co-Sched); smoke: pass "
          f"({len(SMOKE_ARCHS)} families, f32 card vs CPU); grid + sweep: "
          f"pass (numpy == torch on the card); perfetto: pass "
          f"({perfetto_rep['spans']} spans); roofline: pass "
          f"({len(SMOKE_ARCHS)} families card == CPU); cp ranks: pass "
          f"({len(cp_rep['rows'])} splits); expert parallel: pass "
          f"({len(ep_rep['rows'])} shapes); dry run: pass "
          f"({len(dry_rep['cells'])} cells); aggregator: pass "
          f"({bench_rep['roofline_cells']} roofline cells); mesh: pass "
          f"({len(mesh_rep['models'])} models, checkpoint bit for bit)")
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
