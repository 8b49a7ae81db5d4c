"""The PyTorch port's main paths on one NVIDIA H100: build, check, encode,
serve, score, generate.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and nothing is caught:

1. print the card (``torch.cuda.get_device_name`` and ``nvidia-smi``);
2. build every CUDA kernel from ``src/repro_torch/csrc`` with nvcc for
   sm_90a and print ptxas's registers / shared memory / spills; the bf16
   streaming-attention kernels' lines again, and their SASS HMMA counts
   (``cuobjdump``): each head-dim instantiation must hold tensor-core
   instructions (head dim 256 included, whose registers and spills are
   printed on their own lines); likewise the bf16 backward's dK/dV and dQ
   kernels (each head dim; at 256 a dV and a dK kernel, their lines again
   on their own) and the int8 matmul's wgmma kernels and their SASS IGMMA
   counts;
3. hold the LUT-exp kernel bit-equal to its plain version (the reference
   sweep shapes and edge values, orders 0/1, f32/bf16, and an unaligned
   view), and its backward kernel bit-equal to the plain backward
   (``lut_exp_bwd_ref``) at phase 16's training shapes (``LUT_BWD_SHAPES``:
   granite-moe's router, falcon-mamba's chunk Ā, zamba2's four Mamba-2
   exponentials) and on an edge vector (±inf, NaN, the underflow cut, a
   run in [-87, -70] with small gradients), f32 and bf16, aligned and
   not; order 0 gives zeros without a launch;
4. hold the paged-attention kernel (split pass + combine) to its plain
   version cut into the same splits, at full-width shapes (32 heads of 128,
   page size 16, ~1000 pages, 8 lanes with 37 to ~2000 live rows, shuffled
   tables): decode and q-block-tiled steps over f32, bf16 and int8 pools,
   GQA, softcap, window, lut0 and exact exp, each at the default split and
   at one page per split; and at phase 11's shapes over bf16 and int8
   pools (lanes of 37 to 4,200 rows, a 128-row chunk): gemma2's 16 × 8
   heads of 256 with softcap 50 and window 4,096 (its edge inside a page),
   gemma3's local layers (window 1,024) and starcoder2's 24 × 2 of 128
   (GQA 12:1); and at phase 13's: granite-moe's 24 × 8 heads of 64 (GQA
   3:1) and grok-1's 48 × 8 of 128 (GQA 6:1) with softcap 30; and at
   phase 15's: internvl2-1b's 14 × 2 of 64 (GQA 7:1: 56 rows a q-block);
   and at phase 17's head band, a rank's 16 × 16 of 128 at mesh 2;
4a. the kernel-config tuner on the card: ``tune(geom_for(deepseek-7b, page
   size 16), platform="cuda", measure=True)`` for the bf16 and the int8
   pool over phase 7's own steps (packed by its scheduler in a dry run on
   a smoke-width engine; the middle step of each kind — decode, mixed,
   prefill — weighted by the number of steps of that kind, and phase 7's
   passes held to the same steps), every candidate (block_q × pages per
   split) timed on kernel #2 and held against the plain version at its
   own config (each step kind's synthetic pool drawn once a pool, not
   once a candidate): each candidate's predicted and measured ms, the
   winner against ``DEFAULT_CONFIG``, the bf16 winner on the int8 pool,
   and how far the roofline's ranking agreed with the measured one;
5. hold the streaming-attention kernel to its plain version at BERT-large
   widths (16 × 64, l 512 and 4096) and deepseek widths (32 × 128, causal,
   l 2048), f32 and bf16, with GQA 4:1, window, softcap, q_offset/kv_len,
   ragged Lq/Lkv, rows that see no key, lut0 and exact exp, each in both
   dtypes, and head dim 256 at gemma2's widths (16 × 8 heads, causal,
   softcap 50, a 4,200-row query that the window of 4,096 bites, kv_len
   4,150 of 4,224 keys; lut and exact exp), and the MoE family's scoring
   shapes (2 × 1024 causal: granite's 24 × 8 heads of 64, GQA 3:1, and
   grok's 48 × 8 of 128, GQA 6:1, softcap 30), and phase 15's calls
   (``ENCDEC_SHAPES``: internvl2's multimodal prefill, GQA 7:1, causal, a
   kv_len cut; seamless-m4t's encoder, non-causal; its decoder's
   self-attention prefill, causal, kv_len 16 of 48; its cross-attention, 16
   and 1,024 rows against 256 frames, non-causal, Lq ≠ Lkv), bf16 also
   against the f32 plain version (``PV_LIMITS``: P·V stays the f32
   product); every bf16
   call counted on the tensor-core kernel, every f32 call on the CUDA-core
   one;
6. encode with BERT-large at full width and depth (random weights from a
   seed) through ``build_model(cfg).prefill`` on 8 × 512 and 1 × 4096
   tokens: 24 streaming-attention launches per forward (bf16: all on the
   tensor-core kernel), tokens/s, peak memory; the masked-LM loss; logits
   through the kernel held against the same forward through the plain
   attention, in bf16 and f32 (f32: all 24 on the CUDA-core kernel);
7. serve 8 requests of deepseek-7b at full width and full depth through
   ``EngineCore`` with a bf16 pool, then an int8 pool, each in two arms:
   the eager arm (``capture=False``, the step dispatched op by op) and
   the captured arm (``capture=True``, the default: one CUDA graph per
   (stream width, table width), replayed).  The captured arm's first
   pass runs in lockstep with an eager twin (equal plans, and the replayed
   graph's logits equal the eager step's bit for bit on every step), warm
   passes
   repeat until one captures nothing new (at most 3), then
   ``obs.mark_warm()`` and a measured pass (step p50/p99, tokens/s, peak
   memory, TTFT/TPOT from the registry, ``step_retraces_total``); every
   pass's greedy streams equal the eager arm's.  Every engine resolves
   the committed ``deepseek-7b::cuda`` row of the tuner's table
   (``source == "tuned"``), and every step's ``StepOutput.kernel_config``
   is the engine's.  Then (bf16) a captured engine at ``DEFAULT_CONFIG``
   beside one on the tuned row, their measured passes interleaved: both
   step p50s, streams equal by the margin rule.  Kernel launches are
   counted over each timed pass (paged attention's split pass and its
   combine, each = layers × steps, replayed steps included).  Profiler
   windows (``obs.arm_profiler``) over one mixed and one pure-decode step
   of each arm print ``profile_summary`` (device time by kernel and by
   group, kernels launched, host launch calls, device idle share) and
   keep the traces gzipped under ``chiprun_out/traces/``.  Then hold one
   full-width ragged step's logits through the kernel against the same
   step through the plain attention, in bf16 on the served pool and in
   f32; score 2 × 1024 tokens causally through ``build_model(cfg).loss``
   (one streaming-attention launch per layer: bf16 on the tensor-core
   kernel, f32 on the CUDA-core one) against the plain attention, in bf16
   and in f32;
7a. the prefix cache at the same width, bf16 and int8 pools: 8 requests
   share a 520-token system prompt, each with its own tail of 32·(i + 1)
   tokens, 32 new each; request 0 runs alone and publishes (page 32 holds
   8 prompt rows and 8 of its tail), requests 1–7 run together and each
   takes a partial-page hit copied on write in place, then all 8 are
   served again (hits up to len − 1).  A cached captured engine, a cached
   eager one and an uncached captured one: captured = eager bit for bit
   (streams, cache stats, pool bytes), streams = the uncached arm's by the
   near-tie margin rule (a fork is read again with both arms' logits), every
   copied original keeps its bits, only cached pages in use after the
   drain; hit and prefill tokens, CoW copies, steps, step p50/p99, TTFT
   of requests 1–7, #2 launches (= layers × steps), peak memory;
7b. speculative decoding at k = 4, bf16 pool: (a) a scripted proposer
   replays phase 7's captured streams of the same 8 prompts, corrupting
   position i % 5 − 1 of its i-th proposal (full, partial and no
   acceptance all occur): streams = phase 7's by the margin rule, one
   capture per (T, P) key it saw, a never-drafting speculative engine
   captures as many keys as phase 7's plain engine, the pool drained, 30
   split passes and 30 combines per step; (b) the default
   ``NGramProposer`` on prompts of a repeated 32-token phrase beside the
   plain engine (warm pass, then a measured one): acceptance, committed
   tokens per step, step p50, tokens/s;
7c. seeded sampling at the same width, bf16 and int8 pools: phase 7's
   prompts, requests 0–3 greedy, 4–6 at temperature 0.8, top_k 50, top_p
   0.95, seeds 1000 + i, 7 at temperature 1.0.  A captured engine (two
   passes capture the (T, P) keys and its one sampler graph, then
   ``mark_warm()`` and a measured pass: 0 captures, two LUT-exp launches
   on every step that samples and none on any other), an eager engine
   (captured = eager bit for bit), each sampled request served alone, a
   pool that forces preemptions and an all-greedy pass (no sampler run):
   greedy streams = phase 7's, alone = batched and preempted = roomy, each
   save near-tie forks (``scores + g`` for a sampled token); the sampler
   on the card against its CPU version on one step's logits (key words,
   bits, uniforms and the LUT exponential bit for bit); step p50/p99,
   tokens/s, the sampler graph's time and its device time by kernel group;
7d. the async front door (``AsyncLMServer``) on 7c's warm bf16 engine: 8
   clients at once stream exactly the batch streams; staggered arrivals
   with one client cancelled after 4 tokens (its pages free before the
   next step): TTFT p50/p99, TPOT, req/s from ``summary()``; one scrape of
   ``/metrics`` on 127.0.0.1;
7e. a checkpoint round trip at 2 layers of deepseek-7b's full width: the
   seeded parameters written in the reference store's layout
   (``arrays.npz``, bf16 leaves as raw 2-byte values, ``manifest.json``
   with sha256; the writer is a fixture here), read back through
   ``checkpoint.restore_params`` onto the card bit for bit, one engine
   step's logits equal bit for bit to an engine on the parameters in
   memory, and a leaf that no longer matches its manifest raises
   ``IOError``;
7f. the padded oracle, on phase 7's weights while they are resident:
   ``EngineCore(mode="padded")`` serves phase 7's 8 requests on the bf16
   and the int8 pool, each step one right-aligned (lanes, C) block (C 1
   on decode-only steps, the chunk of 256 otherwise; idle lanes at
   kv_len 0), eagerly: #2's block entry (``paged_attention``, the
   counterpart of ``paged_attention_4d``) and its combine each launched
   layers × steps, the pool drained, 0 standalone #1 launches (greedy),
   greedy streams = phase 7's captured ragged streams by the margin rule;
   the padded step p50 beside phase 7's captured step p50.  One block
   (``PADDED_BLOCK``: a full chunk, a 100-token first chunk whose 156
   padding rows sit at negative positions, five decodes, an idle lane)
   at the depth of ``step_check_cut`` through #2 against its plain
   version in bf16 and in f32 (phase 7's rule), every layer's kernel
   output finite and its rows that see no key exactly zero; #2 timed at
   the pass's two block shapes (8 × 1 decode, 8 × 256 with one chunk
   lane) beside its plain version and SDPA on a gathered view, with its
   bound (the ``padded_block`` entry of the kernels line);
8. hold the activation quantisation kernel (``quantize_dynamic``)
   bit-equal to its plain version, int8 values and scale, f32 and bf16:
   ragged and unaligned sizes, all zeros, exact .5 ties, an outlier,
   bits=4; hold both int8 matmul variants (wgmma, and mma.sync) bit-exactly
   to their plain version on both weight layouts, accumulators and
   outputs: the reference suite's shapes, a batch, M = 1 and 8, ragged M,
   N and K, and all-±127 operands past 2^24;
9. the INT8 path at BERT-large width and depth: quantise the 144 projection
   weights (wq, wk, wv, wo, up, down of 24 layers) with ``quantize(w,
   axis=0)`` (K-major) and push real activations of 8 × 512 tokens through
   ``dense_maybe_quant``: 144 quantisation launches, 144 wgmma launches, 0
   mma.sync, 0 weight transposes; every output bit-equal to the plain
   version, int32 accumulators included, and within 3% (relative) of the
   bf16 product in f32; the pass timed whole, by part (quantisations,
   products, GELUs) and by its host work alone; the pass captured once as
   a CUDA graph (a measurement), its replay bit-equal to the eager pass
   and timed beside it;
10. time each kernel at its main path's shapes (paged attention and its
   combine at the engine's decode step, the LUT exp at the sampler's
   (lanes, V) scores and at the decode step's logits, paged attention
   also at a mixed step of one 256-token prefill chunk and 7 decodes, and
   at a verify step of 8 lanes × (1 + 4) rows, and at the three shapes
   beside SDPA three ways: as a caller sees it, the device
   time alone and the host time per call, at the engine's tuned config
   and, device alone, at ``DEFAULT_CONFIG``; streaming attention at the BERT
   encode and deepseek scoring shapes, and at head dim 256 at gemma2's
   scoring shape and the slot engine's 4,200-row local-layer prefill
   (SDPA causal only beside it), with exact exp and the f32 CUDA-core
   kernel beside it; the int8 matmul at the BERT-large projections, device
   alone too, with its mma.sync variant, each wgmma tile width and
   ``_int_mm`` on both weight layouts; the quantisation kernel at the
   pass's two input shapes; the LUT exp device alone and host per call;
   paged attention at internvl2-1b's GQA 7:1 decode beside SDPA with
   ``enable_gqa``; streaming attention at phase 15's four calls beside
   the SDPA call of the same function: ``enable_gqa`` and a kv_len mask
   for internvl2's prefill, plain non-causal SDPA for the encoder and the
   cross-attention, a mask for the decoder's self-attention)
   beside its plain version, a library yardstick and its roofline bound,
   for the ``{"kernels": [...]}`` line, printed after phases 11 and 13
   have added their launches and #2's and #1's times at their shapes;
   the end-to-end times beside
   the readings before the split-KV kernel and the bf16 unembed;
11. the dense families beside deepseek-7b, at their published widths and
   full depth, one model at a time (each freed before the next, deepseek
   before the first), seeded weights: gemma2-9b (local/global layers,
   softcaps, post-block norms) on a bf16 and an int8 pool, gemma3-12b
   (5:1 local/global, local RoPE theta, QK-norm) and starcoder2-3b
   (LayerNorm, biases, GQA 12:1) on a bf16 pool.  Each serves phase 7's
   prompts, plus one of 4,200 tokens (gemma2) or 1,500 (gemma3) that its
   window bites, through ``EngineCore`` as phase 7's captured arm does: in
   lockstep with an eager twin (equal plans, logits bit for bit on every
   step) at the depth of ``step_check_cut``, then at full depth a first
   pass, warm passes, ``mark_warm()`` and a measured pass
   (step p50/p99, tokens/s, peak memory; 0 captures after
   ``mark_warm()``; #2's split pass and combine each = layers × steps),
   then a pass whose first 8-lane decode step is profiled.  One
   full-width ragged step with a lane past the window, through the kernel
   against the plain attention (``phase_step_vs_plain``).  gemma2:
   requests 4–7 sampled with 7c's parameters, captured = eager bit for
   bit (the final softcap precedes the sampler), 2 LUT-exp launches per
   sampling step; #2 timed at its decode and at a mixed step whose chunk
   the window bites.  starcoder2: #2 timed at its decode beside SDPA with
   ``enable_gqa``.  Each model scores 2 × 1024 through
   ``build_model(cfg).loss`` on #3 (one launch per layer: 42, 48 and 30;
   head dim 256 for the gemmas) against the plain attention;
12. the slot engine (``ServingEngine``) at full width and depth: deepseek-7b
   (8 slots × 1,088 rows, phase 7's weights and prompts, 32 new each),
   bf16 cache then int8 — a lockstep pass of the captured decode beside an
   eager twin (bit for bit every step), then a measured pass: #3 once per
   prompt on every layer whose cache is not int8, #2 never, streams equal
   phase 7's ``EngineCore`` streams save margin-rule forks, and in f32
   (after phase 7's scoring widens the weights; a measured pass only)
   equal to an f32 ``EngineCore``'s; gemma2-9b (8
   slots × 8,192 rows, inside phase 11 on its weights, phase 11's 9
   prompts): 21 local layers keep rings of 4,096 rows, the 4,200-token
   prompt's ring wraps and holds its last 4,096 positions, the cache's
   bytes equal the arithmetic (with rings and without), streams equal
   phase 11's ``EngineCore`` streams save margin-rule forks, and again
   at full width cut to two periods in f32, against an f32
   ``EngineCore``; prefill ms by prompt length, decode step p50/p99,
   tokens/s, peak memory;
13. the MoE family, one model at a time after phase 11's are freed,
   seeded weights: granite-moe-3b-a800m at its published widths and full
   depth (32 layers, 40 experts top-8 of width 512) on a bf16 and an int8
   pool, grok-1-314b at its published widths cut to 2 layers (8 experts
   top-2 of width 32,768, softcap 30; its 64 layers fit no card) on a
   bf16 pool.  Each serves phase 7's prompts as phase 11 does, and the
   measured pass launches
   #1 (the router softmax's LUT exponential) layers × steps times beside
   #2's split pass and combine.  granite: one full-width mixed step
   through the kernels against the plain attention
   (``phase_step_vs_plain``; a smoke only: routing flips at near-ties
   spread the two plain schedules as far), layer 0's experts alone on that step's
   input in f32 against the same call on the CPU (equal routing, ``y``
   within ``F32_TOL``, ``aux`` within 1e-6 relative), the bf16 layer and
   its router timed as replayed graphs at that stream and at a decode
   stream.  Each: #2 timed at
   its decode (granite beside SDPA with ``enable_gqa``), #1 at the
   router's (1, 384, E) and (1, 8, E) f32 logits, and scoring 2 × 1024
   on #3 in bf16 and, the weights widened, in f32 — a smoke of the path
   and its 32 / 2 launches: routing flips leave these checks too loose to
   decide #3, which phase 5 holds at both shapes —: the f32 loss, ``ce``
   and ``aux`` each held to the plain attention by the margin rule, the
   bf16 ones to the f32 plain run (``hold_moe_losses``: random-weight
   routing flips at bf16 near-ties, so two plain bf16 schedules' spread
   undersamples how far bf16 runs part);
14. the SSM families, one model at a time after phase 13's are freed,
   seeded bf16 weights at their published widths and full depth:
   falcon-mamba-7b (64 Mamba-1 layers, d_inner 8192, state 16) and
   zamba2-1.2b (38 Mamba-2 layers, a shared attention + MLP block before
   each of 6 periods of 6, a tail of 2).  ``EngineCore`` refuses each
   (``UnsupportedCacheLayout("ssm_state")``); the slot engine (8 slots ×
   1,088 rows) serves phase 7's prompts, 32 new each: a lockstep pass of
   the captured decode beside an eager twin (logits, picks and every cache
   leaf bit for bit on every step), then a measured pass — #1 launched
   layers × (1 or 4 per chunk of every prefill + 1 per decode step), #3
   6 times per zamba2 prompt (its shared block's prefill), #2 never, the
   cache's bytes equal to the arithmetic, prefill ms by prompt length,
   decode p50/p99, tokens/s, peak memory — and one replayed decode step
   profiled (kernels and device time by group).  Then layer 0's mixer at
   full width in f32 on the card against the CPU: 300 rows (three chunks,
   the last partial) from a non-zero carried state, then four decode
   steps, ``y``, the scan state and ``conv`` each within ``SSM_REL_TOL``
   of its own scale;
15. the vlm and encoder-decoder families, one model at a time after phase
   14's are freed, seeded bf16 weights at their published widths and full
   depth: (a) internvl2-1b (24 layers, 896, 14:2 heads of 64, vocab
   151,655) serves phase 7's prompts as text through ``EngineCore`` as
   phase 11 does (captured in lockstep with an eager twin, 0 captures
   after ``mark_warm()``, #2's split pass and combine = layers × steps,
   requests 4–7 sampled with 2 LUT-exp launches a sampling step), then
   the multimodal entry: ``Model.prefill`` of 8 requests, each a seeded
   (256, 896) patch prefix and 128 tokens (#3 24 times), held against
   ``lm_apply`` with the prefix on the plain attention by the margin rule
   in bf16 and, the weights widened, in f32 (the CUDA-core kernel), and
   32 greedy ``decode_step``s at Lp + L + t (no #3); (b)
   seamless-m4t-large-v2 (24 + 24 layers, 1,024, 16 × 64, vocab 256,206):
   ``EngineCore`` refuses it (``no_paged_step``) and so does the slot
   engine; the Model API generates 32 greedy tokens for 8 requests, each
   (256, 1024) seeded frames and 16 tokens (#3 72 times a prefill: 24
   encoder, 24 decoder self-attention, 24 cross-attention; 0 a decode
   step; the cross K/V carried unchanged), the prefill's logits held
   against ``decode_trunk`` on the plain attention by the margin rule;
   encode ms, prefill ms, decode p50/p99, tokens/s, peak memory; then the
   scoring loss on 2 × (256 frames + 1,024 tokens) through
   ``Model.loss`` (#3 72 times) against the plain attention;
16. training: the backward kernel of #3 (``streaming_attention_bwd``)
   held against its plain backward from the forward kernel's own out and
   lse, bf16 and f32, at ``BWD_SHAPES`` (bert-large 8 × 16 × 512 × 64;
   deepseek-7b 8 × 32 × 512 × 128 causal; grok's 2 × 48:8 × 1024 × 128
   with cap 30; seamless's cross shape, 8 × 16 rows against 256 frames;
   a window + kv_len + q_offset case; at head dim 256 gemma2-9b's 8 ×
   16:8 × 512 causal with cap 50 and gemma3-12b's 2 × 16:8 × 2,048 local
   (window 1,024) and global layers), within ``BWD_TOL``, and bit-equal
   over two calls; then ``Trainer.run()`` (``TRAIN_MODELS``) on
   bert-large at full width and depth (24 layers) and deepseek-7b at full
   width cut to 4 of 30 layers, seeded weights, 8 and 6 steps of 8 × 512
   tokens (the masked-LM loss; the reference's labelled loss, each
   position against its label, the pipeline's own token), a checkpoint
   every 3 steps into a temporary directory and a ``FailureInjector``
   failure at step 4 (restore step 3, resume), losses bit-equal to an
   uninterrupted run's; and at head dim 256, without checkpoints,
   gemma2-9b cut to 4 of 42 layers on 8 × 512 tokens and gemma3-12b cut
   to 6 of 48 on 2 × 2,048 (its local window bites), 4 steps each: for
   every model finite losses and gradient norms, #3's forward and
   backward launched layers × the steps run (every bf16 backward on the
   tensor cores), step ms p50, tokens/s, peak memory and one profiled
   step's device time by group; step 0 against the plain attention at
   two key blockings (``step0``; gemma3-12b in f32, ``TRAIN_TWIN_F32``)
   within ``TRAIN_TWIN_FLOOR``'s rule; the backward kernel timed beside
   its plain version, SDPA's forward plus backward where no softcap rules
   it out (a window or a q_offset through a mask; as a caller sees it,
   and its kernels' device time alone from the profiler) and its bound;
   and then, through #1's backward kernel (``TRAIN_LUT_MODELS``),
   granite-moe-3b-a800m at full depth (8 × 512; the router on #1 every
   layer), zamba2-1.2b at full depth (4 × 512; Mamba-2's decays on #1, the
   shared block on #3) and falcon-mamba-7b cut to 2 of 64 layers (2 ×
   512; Mamba-1's chunk Ā on #1), 4 steps, bf16 moments, no checkpoint:
   #1's forward and backward launches = the formula per step
   (``lut_launches_per_step``: zamba2's backward skips the last chunk's two
   state exponentials, which no loss reads), #3's = the attention calls;
   step 0
   against a run whose #1 is its plain version under autograd (the loss
   bit for bit, the gradient norm within ``max(3 × the spread of two
   plain runs, 1e-5)``); #1's backward timed at ``LUT_BWD_SHAPES`` (as a
   caller sees it, device alone, host per call) beside the plain backward,
   ``g · exp(x)`` (the exact exponential's backward, a yardstick) and its
   bound;
17. tensor-parallel serving, after every other model is freed: #2 timed
   at a rank's head band of deepseek-7b at mesh 2 (16 of 32 heads, the
   decode step beside SDPA on gathered views, and a mixed step), then
   ``launch.mesh.spawn`` starts 2 ranks on this card over gloo
   (``TP_RANKS``; ``tp_rank``), each drawing phase 7's seeded deepseek-7b
   weights at full width and serving phase 7c's traffic (requests 4–7
   sampled) through ``EngineCore(mesh=2)`` on the bf16 pool and then the
   int8 pool, eagerly: the ranks' streams equal (a hash all-gathered),
   #2's split passes and combines on each rank = layers × steps, the pool
   drained, ``measure_collective_bytes(width)`` = the reference's
   ``collective_bytes_per_token`` × width at the wire's itemsize over 4
   (the port gathers the bf16 attention output, the reference an f32
   one); rank 0 then serves the same traffic through a single-device
   eager engine while rank 1 waits: streams token-identical, the logits
   rows of every request's first two tokens bit-equal, and the streams
   held to phase 7c's captured ones by the margin rule; then the paper's
   multi-core softmax across the 2 ranks at the sampler's shape ((8,
   102,400) f32 split on the vocabulary; ``sharded_softmax`` and
   ``sharded_softmax_tree`` against ``lut_softmax`` within 3e-6, the
   butterfly one round per reduce), ``ring_attention`` (2 × 1,024, 32 ×
   128, causal, the sequence split) and ``distributed_decode_attention``
   (kv 1,024) against the plain single-device attention within atol 5e-5,
   rtol 1e-4 (the reference tests' tolerances); the mesh step p50 beside
   the single-device eager p50, the all-gathers' wall time a step, and
   the phase's own seconds;
18. tensor-parallel training and the pipeline: #3 and its backward at a
   rank's head band of deepseek-7b at mesh 2 (``TP_BAND``: 16 of 32
   heads, 8 × 512 causal, bf16) held to their plain versions, bit-equal
   to the same heads of the 32-head launch, and timed beside SDPA and
   their bounds; then ``launch.mesh.spawn`` starts 2 ranks on this card
   (``tp_train_rank``), each running ``Trainer(mesh=Mesh((1, 2), ("data",
   "model")))`` on phase 16's deepseek-7b cut (4 layers, 8 × 512, bf16
   moments, seed 0, the schedule of its 6 steps) for 2 steps: ZeRO-3
   blocks, the split leaves all-gathered every step, #3 forward and
   backward at the band (layers × steps a rank), the run's end saving the
   gathered state (rank 0 writes); step 0's loss bit-equal to phase 16's,
   the later losses and every gradient norm within ``TP_TRAIN_RTOL``; the
   ranks' logs the same bits; then ``compressed_psum`` of seeded card
   tensors = bf16(a) + bf16(b) widened, bit for bit, and
   ``pipeline_apply`` over the 2 ranks (2 stages of 2 of the trained
   layers, 4 microbatches of 2 × 512) bit-equal to the 4 layers in
   sequence on each microbatch; then one device restores the mesh's
   checkpoint and runs step 2, held to phase 16's the same way; each
   rank's peak memory, the mesh step p50, the collectives' calls and
   bytes a rank, the phase's seconds;
19. print the card's name and power limit, then ``{"ok": true, "device":
   {...}}`` as the last line.

Phase 3 also holds #1 bit for bit at phase 14's shapes (falcon's chunk
and decode Ā, zamba2's intra-chunk decay), phase 5 holds #3 at zamba2's
shared prefill (1 × 1024, 32 heads of 64, causal), and phase 10 times #1
at falcon's two shapes beside ``torch.exp`` and #3 at zamba2's prefill
beside SDPA and at the MoE scoring shapes (granite beside SDPA with
``enable_gqa``).  The plain-attention step checks of phases 7, 11 and 13
(``phase_step_vs_plain``) and the eager lockstep twins of phases 11 and
13 run at full width cut to ``STEP_CHECK_LAYERS`` layers or two whole
periods (``step_check_cut``), which keeps every path driven and every
kernel held while their eager and plain schedules' host work shrinks
(``tools/step_check_cost.py`` times both depths of the step checks).  ``[phases]``
prints the seconds of each phase.

Exits non-zero without a result when no CUDA card is visible.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

DEV = "cuda"
MODEL = "deepseek-7b"
ENGINE = dict(lanes=8, page_size=16, num_pages=1024, chunk_size=256)
PROMPT_LENS = (64, 1024)           # prompt lengths drawn in [lo, hi]
MAX_NEW = 32
HQ, D, PS, N_PAGES = 32, 128, 16, 1000          # attention-check widths
KV_LENS = [37, 311, 598, 870, 1142, 1414, 1700, 1990]     # 37 … ~2000
CHUNK = 128                        # the prefill chunk of the tiled checks
# Phase 11: the dense families served beside deepseek-7b, each with the
# prompt that makes its window mask keys (none: starcoder2 has no window)
FAMILIES = (("gemma2-9b", 4200), ("gemma3-12b", 1500), ("starcoder2-3b", None))
# Phase 4's checks at their shapes: (label, heads, kernel keywords)
FAMILY_SHAPES = (
    ("gemma2 16×8×256 cap=50 window=4096", dict(hq=16, hkv=8, d=256),
     dict(cap=50.0, window=4096)),
    ("gemma3 local 16×8×256 window=1024", dict(hq=16, hkv=8, d=256),
     dict(window=1024)),
    ("starcoder2 24×2×128 gqa 12:1", dict(hq=24, hkv=2, d=128), {}),
    ("granite 24×8×64 gqa 3:1", dict(hq=24, hkv=8, d=64), {}),
    ("grok 48×8×128 cap=30 gqa 6:1", dict(hq=48, hkv=8, d=128),
     dict(cap=30.0)),
    ("internvl2 14×2×64 gqa 7:1", dict(hq=14, hkv=2, d=64), {}))
FAMILY_KV_LENS = [37, 611, 1185, 1759, 2333, 3100, 4111, 4200]
FAMILY_PAGES = 1250

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12,    # dense; f32 off tensor cores
              "int8": 1979e12}
F32_TOL = dict(atol=2e-5, rtol=1e-4)
SA_TOL = dict(atol=3e-5, rtol=1e-4)  # the reference kernel suite's
BERT = "bert-large"
BERT_SHAPES = ((8, 512), (1, 4096))  # the paper's l, and the top of its sweep
MASK_ID = 103                        # [MASK] in BERT's WordPiece vocab
SCORE_SHAPE = (2, 1024)              # deepseek-7b causal scoring batch
INT8_TOKENS = (8, 512)               # the BERT-large int8 pass
INT8_PROJ = ("wq", "wk", "wv", "wo", "up", "down")
INT8_REL_TOL = 0.03                  # the reference's own bound (test_quant.py)
# The readings on this card before the split-KV paged kernel and the bf16
# unembed (PERF.md), printed beside this run's: encode, scoring and
# engine-step ms
EARLIER_MS = {"bert 8x512": 24.1, "bert 1x4096": 33.7, "scoring bf16": 104.0,
              "scoring f32": 584.2, "step p50 bf16": 70.78,
              "step p50 int8": 91.61}
TUNE_ITERS = 10                    # timed calls per tuner candidate and step (min)
CKPT_LAYERS = 2                    # depth of the checkpoint round trip
WARM_PASSES = 3                    # the captured arm's warm passes, at most,
                                   # the lockstep pass included
MIXED_CHUNK = (256, 512)           # the mixed step's chunk: (tokens, live rows)
PREFIX_SHARED, PREFIX_TAIL = 520, 32  # the prefix phase: system prompt, tail unit
SPEC_K = 4                         # drafts per decode lane, speculative phase
# Phase 12: the slot engine per model (slots, max_len): phase 7's prompts
# (up to 1,024 tokens) and 32 new; gemma2's 4,200-token prompt
SLOT_ENGINES = {"deepseek-7b": dict(slots=8, max_len=1088),
                "gemma2-9b": dict(slots=8, max_len=8192)}
SPEC_PHRASE = 32                   # the repeated phrase of its NGram prompts
# Phase 13: the MoE family (name, layers kept — None: full depth —, pools
# as kv_quant flags); grok-1-314b's 64 layers (~628 GB in bf16) fit no
# card, so it runs its published widths at 2 layers
MOE_MODELS = (("granite-moe-3b-a800m", None, (False, True)),
              ("grok-1-314b", 2, (False,)))
# The depth of the plain-attention step checks (``step_check_cut``)
STEP_CHECK_LAYERS = 4
# Phase 3's #1 checks at phase 14's shapes: (label, f32 shape, inputs drawn
# in [-hi, 0])
SSM_LUT_SHAPES = (
    ("falcon-mamba chunk Ā = exp(Δ ⊗ A)", (1, 128, 8192, 16), 16.0),
    ("falcon-mamba decode Ā", (8, 1, 8192, 16), 16.0),
    ("zamba2 intra-chunk decay", (1, 64, 128, 128), 60.0))
# Phase 14: the SSM families on the slot engine (8 slots × 1,088 rows:
# phase 7's prompts and 32 new), and layer 0's mixer card vs CPU in f32 on
# 300 rows (three chunks of 128, the last partial) within this share of
# each value's own scale
SSM_MODELS = ("falcon-mamba-7b", "zamba2-1.2b")
SSM_SLOTS = dict(slots=8, max_len=1088)
SSM_LAYER_ROWS = 300
SSM_REL_TOL = 1e-4
# Phase 15: the vlm family (internvl2-1b: phase 7's prompts as text through
# EngineCore, then the multimodal prefill of VLM_BATCH requests, each a
# 256-patch prefix and VLM_PROMPT tokens, and GEN_NEW greedy decode steps)
# and the encoder-decoder (seamless-m4t-large-v2: ENCDEC_BATCH requests,
# each 256 frames and ENCDEC_PROMPT tokens, GEN_NEW greedy tokens; scoring
# ENCDEC_SCORE tokens behind 256 frames)
VLM_MODEL, VLM_BATCH, VLM_PROMPT = "internvl2-1b", 8, 128
ENCDEC_MODEL, ENCDEC_BATCH, ENCDEC_PROMPT = "seamless-m4t-large-v2", 8, 16
ENCDEC_SCORE = (2, 1024)
GEN_NEW = 32
# Phase 17: tensor-parallel serving in TP_RANKS gloo ranks on the card; the
# multi-core softmax at the sampler's shape and ring attention at
# deepseek's scoring shape (B, heads, L, D), held to the reference tests'
# tolerances
TP_RANKS = 2
TP_TIMEOUT_S = 420
TP_SOFTMAX = (8, 102400)
TP_RING = (2, 32, 1024, 128)
TP_ATTN_TOL = dict(atol=5e-5, rtol=1e-4)
# Phase 18: the training half in TP_RANKS gloo ranks: Trainer(mesh=Mesh((1,
# TP_RANKS), ("data", "model"))) on phase 16's deepseek-7b cut (layers,
# tokens, bf16 moments, seed, the 6-step schedule) for TP_TRAIN_STEPS steps,
# then one step on one device from the mesh's checkpoint.  The mesh's
# gradients are the single device's bits; its global norm sums each
# leaf's squares in another order (PERF.md §6, PR 34): a pairwise f32
# sum of n ≤ 4.2e8 squares (the embedding) is within log2(n)·2^-24 ≈
# 1.7e-6 of its value in either order, so the two norms (the square
# root halves it, the two orders double it) agree within ~1.7e-6, and
# the later losses, which see the norm only through the clip scale, by
# less: the norms and the later losses are held to phase 16's within
# TP_TRAIN_RTOL, ~6× that bound (the CPU twins' 1e-5), step 0's loss bit
# for bit.  #3 and its backward run at the band TP_BAND; the pipeline
# at 2 stages of TP_TRAIN_LAYERS / 2 layers, TP_PIPE_M microbatches of
# TP_PIPE_MB rows; compressed_psum on TP_PSUM_SHAPE
TP_TRAIN_LAYERS, TP_TRAIN_STEPS, TP_TRAIN_TOTAL = 4, 2, 6
TP_TRAIN_SHAPE = (8, 512)
TP_TRAIN_RTOL = 1e-5
TP_BAND = ("deepseek-7b band 8 × 16 × 512² × 128 causal (mesh 2)",
           (8, 16, 16, 512, 512, 128), dict(causal=True))
TP_PIPE_M, TP_PIPE_MB = 4, 2
TP_PSUM_SHAPE = (4096, 1024)
# (M, K, N, what): the projections of an 8 × 512 batch, then the reference
# microbenchmark's shape
INT8_TIMED = [(4096, 1024, 1024, "wq/wk/wv/wo"), (4096, 1024, 4096, "up"),
              (4096, 4096, 1024, "down"),
              (256, 1024, 1024, "benchmarks/microbench.py bench_int8")]


#: the card's ``nvidia-smi`` name and power limit, printed beside the times
#: of the phases this slice added
CARD = ["card not read"]


def log(*a):
    print(*a, flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# ----------------------------------------------------------------- helpers --

def cuda_ms(fn, *, iters=20, warmup=3, flush=None, spin=False):
    """Median time of ``fn`` in ms, CUDA events around each call; ``flush``
    (untimed) runs before each call to evict the L2 cache.  The events
    start when the host reaches ``fn``, so a call whose host work outlasts
    its device work reads its host time.  ``spin`` puts ~1 ms of spinning
    on the stream ahead of each call, so the host has enqueued all of
    ``fn`` before the first event fires: the device time alone."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush()
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


SPIN_CYCLES = 2_000_000            # ~1 ms at the H100's boost clock


def host_ms(fn, *, calls=50):
    """Host time of one call of ``fn`` in ms: ``calls`` calls enqueued back
    to back while the stream spins (~20 ms), so no call waits on the card."""
    import torch
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(20 * SPIN_CYCLES)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e3


def interleaved_ms(timers, *, rounds=5):
    """Each zero-argument timer of ``timers`` run ``rounds`` times in turn
    (A, B, C, A, B, C, …) → name → the median of its readings.  Readings
    drift within a call; turns spread the drift over every configuration."""
    out = {k: [] for k in timers}
    for _ in range(rounds):
        for k, timer in timers.items():
            out[k].append(timer())
    return {k: float(np.median(v)) for k, v in out.items()}


def bf16_ulps(got, want, atol=F32_TOL["atol"]) -> float:
    """Largest |got − want| beyond the f32 atol, in bf16 ulps of the larger
    magnitude.  Both sides sum in f32 and round once to bf16, so they may
    land one ulp apart; near zero, where the f32 sums cancel, the f32
    tolerance's atol is the floor instead."""
    import torch
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    excess = ((g - w).abs() - atol).clamp_min(0.0)
    return float((excess / ulp).max())


# The bf16 tensor-core attention kernel multiplies p_hi + p_lo (two bf16
# halves of each f32 weight) by V so that P·V stays the plain version's f32
# product.  Within one bf16 ulp does not show that: p rounded once, or p_hi
# alone, stays within it.  These two statistics do (limits chosen from a
# float64 model of a 512-key softmax before any card run: the split reads
# rms ratio 1.0000 and bias ~2e-5, p rounded once 1.30, p_hi alone 2.03 and
# −2.3e-3).
PV_LIMITS = dict(rms_ratio=1.05, bias=2.0 ** -12)


def bf16_pv_precision(got, want32) -> dict:
    """bf16 outputs ``got`` against the f32 plain version ``want32``:
    ``rms_ratio``, the rms of got − want over the rms of bf16(want) − want
    (1 when the kernel's f32 result rounds as the plain one does), and
    ``bias``, Σ(got − want)·want / Σ want² (0 unless the weights are
    rounded one way)."""
    import torch
    g, w = got.double(), want32.double()
    base = float((want32.to(torch.bfloat16).double() - w).square().mean()
                 .sqrt())
    rms = float((g - w).square().mean().sqrt())
    ratio = rms / base if base > 0 else (0.0 if rms == 0 else np.inf)
    return dict(rms_ratio=ratio,
                bias=float(((g - w) * w).sum() / w.square().sum()))


def pv_precision_ok(stats) -> bool:
    return (stats["rms_ratio"] <= PV_LIMITS["rms_ratio"]
            and abs(stats["bias"]) <= PV_LIMITS["bias"])


# ------------------------------------------------------------------ phases --

def phase_card():
    import torch
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    CARD[0] = smi_line
    log(f"[card] {name} | torch {torch.__version__} cuda {torch.version.cuda}")
    return name, smi_line


def sass_counts(lib, opcode):
    """Per kernel function of a built library, how many SASS instructions
    carry ``opcode`` (``cuobjdump -sass`` from the toolkit that built it)."""
    from repro_torch.kernels import build
    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    out = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                         text=True, timeout=120)
    if out.returncode != 0:
        fail(f"cuobjdump -sass {lib}: {out.stderr.strip()}")
    counts, fn = {}, None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and opcode in line:
            counts[fn] += 1
    return counts


def phase_build():
    """Build every kernel; → the tensor-core attention kernels' ptxas lines
    (registers, spills) and their SASS tensor-core instruction counts."""
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"[build] {sorted(libs)} in {time.perf_counter() - t0:.1f} s "
        f"({build.build_dir()})")
    report = build.ptxas_report()
    for name, lines in report.items():
        for line in lines:
            log(f"[ptxas {name}] {line}")
    tc_kernel = "tensor_core16attention_kernel"    # the mangled name's tail
    tc = [line for line in report["streaming_attention"] if tc_kernel in line]
    for line in tc:
        log(f"[tensor_core kernel] {line}")
    d256 = [line for line in tc if "ILi256E" in line]
    for line in d256:
        log(f"[tensor_core kernel D 256] {line}")
    if len(d256) != 3:
        fail(f"streaming attention: {len(d256)} head-dim-256 instantiations "
             f"of the bf16 kernel, expected one per exp mode")
    hmma = {fn: n for fn, n in sass_counts(libs["streaming_attention"],
                                           "HMMA").items()
            if tc_kernel in fn}
    log(f"[tensor_core kernel] SASS HMMA instructions per instantiation "
        f"(head dim × exp mode): {sorted(hmma.values())}")
    if not tc or len(hmma) != len(tc) or not all(hmma.values()):
        fail(f"streaming attention: the bf16 kernels are not all on the tensor "
             f"cores (ptxas {len(tc)}, HMMA {hmma})")
    bwd = bwd_tensor_core(report, libs)
    wg_kernel = "wgmma_kernel"
    wg = [line for line in report["int8_matmul"] if wg_kernel in line]
    for line in wg:
        log(f"[int8 wgmma kernel] {line}")
    igmma = {fn: n for fn, n in sass_counts(libs["int8_matmul"],
                                            "IGMMA").items()
             if wg_kernel in fn}
    log(f"[int8 wgmma kernel] SASS IGMMA instructions per tile width: "
        f"{sorted(igmma.values())}")
    if not wg or len(igmma) != len(wg) or not all(igmma.values()):
        fail(f"int8 matmul: the wgmma kernels hold no wgmma instructions "
             f"(ptxas {len(wg)}, IGMMA {igmma})")
    return dict(ptxas=tc, ptxas_d256=d256, sass_hmma=hmma, backward=bwd,
                int8_wgmma_ptxas=wg, int8_sass_igmma=igmma)


def bwd_tensor_core(report, libs):
    """#3's bf16 backward: ptxas's line and the SASS HMMA count of each
    instantiation of its dK/dV kernels (``<D, part>``: both outputs, or at
    D 256 a dV and a dK kernel) and its dQ kernels (``<D>``); fails unless
    every head dim of ``ops.BWD_HEAD_DIMS`` has both passes and every
    instantiation a ptxas line and tensor-core instructions."""
    import re
    from repro_torch.kernels.streaming_attention.ops import BWD_HEAD_DIMS
    passes = {"dK/dV": "tensor_core11dkdv_kernel", "dQ": "tensor_core9dq_kernel"}
    lines = [line for line in report["streaming_attention_bwd"]
             if any(k in line for k in passes.values())]
    for line in lines:
        log(f"[tensor_core backward] {line}")
        if "ILi256E" in line:
            log(f"[tensor_core backward D 256] {line}")
    hmma = {fn: n for fn, n in sass_counts(libs["streaming_attention_bwd"],
                                           "HMMA").items()
            if any(k in fn for k in passes.values())}
    out = {}
    for name, key in passes.items():
        counts = {fn: n for fn, n in hmma.items() if key in fn}
        dims = {int(re.search(r"ILi(\d+)E", fn).group(1)) for fn in counts}
        log(f"[tensor_core backward] {name}: SASS HMMA instructions per "
            f"instantiation: " + json.dumps(counts))
        if dims != set(BWD_HEAD_DIMS) or not all(counts.values()) \
                or sum(key in line for line in lines) != len(counts):
            fail(f"backward {name}: not every head dim {BWD_HEAD_DIMS} has a "
                 f"tensor-core kernel with a ptxas line (HMMA {counts})")
        out[name] = counts
    return dict(ptxas=lines, sass_hmma=out)


def phase_lut_exp():
    import torch
    from repro_torch.kernels.lut_exp import lut_exp, lut_exp_ref
    rng = np.random.default_rng(0)
    # ... and internvl2-1b's sampler scores, (lanes, 151,655): rows of an
    # odd length, so each row after the first starts off the 16-byte grid
    shapes = [(7,), (128,), (3, 5, 11), (256, 128), (1, 1), (1000,),
              (1 << 20,), (ENGINE["lanes"], 151655)]
    edges = np.array([-1e30, -100.0, 0.0, 80.0], np.float32)
    checked = 0
    for shape in shapes:
        x = rng.uniform(-20, 20, size=shape).astype(np.float32)
        for dt in (torch.float32, torch.bfloat16):
            for order in (0, 1):
                for arr in (x, np.concatenate([edges, x.reshape(-1)])):
                    xt = torch.from_numpy(arr).to(DEV, dt)
                    got = lut_exp(xt, order=order)
                    want = lut_exp_ref(xt, order=order)
                    torch.cuda.synchronize()
                    if not torch.equal(got.view(torch.int16 if dt == torch.bfloat16
                                                else torch.int32),
                                       want.view(torch.int16 if dt == torch.bfloat16
                                                 else torch.int32)):
                        fail(f"lut_exp not bit-equal: shape {shape} {dt} "
                             f"order {order}")
                    checked += 1
    # a start off the 16-byte grid: the element-wise path
    base = torch.from_numpy(rng.uniform(-20, 20, 4099).astype(np.float32)).to(DEV)
    for dt in (torch.float32, torch.bfloat16):
        xt = base.to(dt)[1:]
        if not bits_equal(lut_exp(xt).float(), lut_exp_ref(xt).float()):
            fail(f"lut_exp not bit-equal on an unaligned {dt} view")
        checked += 1
    log(f"[lut_exp] bit-equal to the plain version in {checked} cases")
    # the SSM discretisations of phase 14, f32: falcon-mamba's chunk Ā =
    # exp(Δ ⊗ A) (Δ = softplus(·) ≥ 0, A = −(1..16)) and its decode step,
    # zamba2's intra-chunk decay exp(min(s_i − s_j, 0))
    for label, shape, hi in SSM_LUT_SHAPES:
        x = torch.rand(shape, device=DEV, generator=torch.Generator(
            device=DEV).manual_seed(31)) * -hi
        for order in (0, 1):
            if not torch.equal(lut_exp(x, order=order).view(torch.int32),
                               lut_exp_ref(x, order=order).view(torch.int32)):
                fail(f"lut_exp not bit-equal at {label} {shape}, order "
                     f"{order}")
        log(f"[lut_exp] {label} {shape} f32 ({x.numel()} values in "
            f"[-{hi}, 0]): bit-equal to the plain version, orders 0/1")
        del x
    # the form the tensor-core attention kernel inlines (lut_exp_nonpos):
    # bit-equal on x <= 0, with the floors where the table index turns
    from repro_torch.kernels.streaming_attention.ops import softmax_exp
    grid = (np.arange(-126 * 128, 1, dtype=np.float64) / 128
            * np.log(2.0)).astype(np.float32)
    x = np.concatenate([edges[:3], np.float32([-0.0, -1e-45, -87.0]), grid,
                        np.nextafter(grid, np.float32(-np.inf)),
                        np.minimum(np.nextafter(grid, np.float32(np.inf)), 0),
                        -rng.uniform(0, 100, 1 << 22).astype(np.float32)])
    xt = torch.from_numpy(x).to(DEV)
    for order in (0, 1):
        got, want = softmax_exp(xt, order=order), lut_exp_ref(xt, order=order)
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            fail(f"lut_exp_nonpos (order {order}) not bit-equal to the plain "
                 f"LUT on x <= 0")
    log(f"[lut_exp] lut_exp_nonpos (the tensor-core attention kernel's form) "
        f"bit-equal to the plain version on {x.size} values x <= 0, orders 0/1")


def phase_lut_exp_bwd():
    """#1's backward kernel against its plain backward (``lut_exp_bwd_ref``
    on the card) bit for bit, at ``LUT_BWD_SHAPES`` and on the edge vector
    (aligned and one element off the 16-byte grid), f32 and bf16: one
    launch at order 1; order 0 zeros and no launch → per case, max|Δ|."""
    import torch
    from repro_torch.kernels.lut_exp import lut_exp
    from repro_torch.kernels.lut_exp.ops import lut_exp_bwd
    from repro_torch.kernels.lut_exp.ref import lut_exp_bwd_ref
    gen = torch.Generator(device=DEV).manual_seed(41)
    cases = [(label, torch.rand(shape, device=DEV, generator=gen) * -hi,
              torch.randn(shape, device=DEV, generator=gen))
             for label, shape, hi in LUT_BWD_SHAPES]
    # the edges, then a run in [-87, -70] whose gradient is 1e-3 × N(0, 1),
    # so g·A and g·A·ln2/K are subnormal there
    rng = np.random.default_rng(43)
    x = np.concatenate([np.float32(LUT_BWD_EDGES),
                        rng.uniform(-87, -70, 4099)]).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    g[len(LUT_BWD_EDGES):] *= np.float32(1e-3)
    x, g = torch.from_numpy(x).to(DEV), torch.from_numpy(g).to(DEV)
    cases += [("edges + [-87, -70] run", x, g),
              ("edges + run, unaligned", x, g)]
    out = {}
    for label, x32, g32 in cases:
        for dt in (torch.float32, torch.bfloat16):
            x, g = x32.to(dt), g32.to(dt)
            if label.endswith("unaligned"):           # one element a thread
                x, g = x[1:], g[1:]
            before = lut_exp.bwd_launches
            got = lut_exp_bwd(x, g)
            zero = lut_exp_bwd(x, g, order=0)
            want = lut_exp_bwd_ref(x, g)
            torch.cuda.synchronize()
            launched = lut_exp.bwd_launches - before
            if launched != 1 or zero.any():
                fail(f"lut_exp_bwd {label} {dt}: {launched} launches, order "
                     f"0 nonzero: {bool(zero.any())}")
            if not bits_equal(got, want):
                bad = int((got.float() != want.float()).sum())
                fail(f"lut_exp_bwd {label} {dt}: not bit-equal to the plain "
                     f"backward ({bad} values differ)")
            err = float((got.float() - want.float()).abs().nan_to_num().max())
            out[f"{label} {str(dt)[6:]}"] = dict(max_abs_err=err,
                                                 values=x.numel())
            del x, g, got, zero, want
        del x32, g32
    del cases
    torch.cuda.empty_cache()
    log(f"[lut_exp backward] bit-equal to the plain backward in "
        f"{len(out)} cases (f32 and bf16 at {len(LUT_BWD_SHAPES)} training "
        f"shapes and the edge vector, aligned and not), one launch each at "
        f"order 1, zeros and none at order 0")
    return out


def make_stream(spec, *, hq=None, hkv=None, d=None, ps=None, n_pages=None,
                pool="bfloat16", q_dtype="bfloat16", seed=0, lanes=8,
                exact_logits=False, width=None):
    """A full-width packed stream in the engine's layout: ``spec`` lists
    (new tokens, live rows after the step) per lane; pages drawn without
    replacement from a shuffled pool; dead rows pad to a power of two; cu
    carries a trailing pseudo-segment and zero-width repeats (lanes + 2);
    ``width`` overrides the stream width (a scheduler bucket).
    ``exact_logits`` draws q and k as small integers, so every q·k sum is
    exact in f32 whatever its order."""
    import torch
    from repro_torch.core.streaming_attention import quantize_kv_rows
    from repro_torch.kernels.paged_attention import varlen_positions
    hq, d, ps = hq or HQ, d or D, ps or PS
    hkv, n_pages = hkv or hq, n_pages or N_PAGES
    rng = np.random.default_rng(seed)
    need = [-(-kv // ps) for _, kv in spec]
    assert sum(need) <= n_pages
    perm = rng.permutation(n_pages)
    width_p = 1 << (max(need) - 1).bit_length()
    nq = np.array([n for n, _ in spec])
    live = int(nq.sum())
    width = width or 1 << (live - 1).bit_length()
    table = np.full((width, width_p), n_pages, np.int32)     # scratch page
    cu = np.concatenate([[0], np.cumsum(nq)]).astype(np.int32)
    off = 0
    for i, k in enumerate(need):
        table[cu[i]:cu[i + 1], :k] = perm[off:off + k]
        off += k
    pos = np.zeros(width, np.int32)
    pos[:live] = varlen_positions(cu, [kv for _, kv in spec])
    cu_full = np.full(lanes + 2, width, np.int32)
    cu_full[:len(cu)] = cu
    g = torch.Generator(device=DEV).manual_seed(seed)
    shape = (n_pages + 1, hkv, ps, d)
    k = torch.randn(shape, generator=g, device=DEV)
    v = torch.randn(shape, generator=g, device=DEV)
    q = torch.randn((width, hq, d), generator=g, device=DEV)
    if exact_logits:
        k = torch.randint(-3, 4, shape, generator=g, device=DEV).float()
        q = torch.randint(-3, 4, q.shape, generator=g, device=DEV).float()
    dev = lambda a: torch.from_numpy(a).to(DEV)  # noqa: E731
    out = dict(q=q.to(getattr(torch, q_dtype)), table=dev(table),
               pos=dev(pos), cu=dev(cu_full), spec=spec, live=live,
               hq=hq, hkv=hkv, d=d, ks=None, vs=None)
    if pool == "int8":
        kq, ks = quantize_kv_rows(k.reshape(1, -1, ps, d))
        vq, vs = quantize_kv_rows(v.reshape(1, -1, ps, d))
        out.update(k=kq.reshape(shape), v=vq.reshape(shape),
                   ks=ks.reshape(shape[:3]), vs=vs.reshape(shape[:3]))
    else:
        out.update(k=k.to(getattr(torch, pool)), v=v.to(getattr(torch, pool)))
    return out


def phase_paged_attention():
    import torch
    from repro_torch.kernels.paged_attention import (
        paged_attention, paged_attention_varlen,
        paged_attention_varlen_reference)
    from repro_torch.kernels.paged_attention.ops import default_kv_split
    decode = [(1, kv) for kv in KV_LENS]
    tiled = [(1, kv) for kv in KV_LENS]
    tiled[3] = (CHUNK, KV_LENS[3])                  # one prefill chunk
    cases = [
        ("decode f32", decode, 1, dict(pool="float32", q_dtype="float32"), {}),
        ("decode bf16", decode, 1, dict(pool="bfloat16"), {}),
        ("decode int8", decode, 1, dict(pool="int8"), {}),
        ("tiled f32", tiled, 8, dict(pool="float32", q_dtype="float32"), {}),
        ("tiled bf16", tiled, 8, dict(pool="bfloat16"), {}),
        ("tiled int8", tiled, 8, dict(pool="int8"), {}),
        ("tiled gqa 4:1 bf16", tiled, 8, dict(pool="bfloat16", hkv=HQ // 4),
         {}),
        ("tiled cap=50 f32", tiled, 8, dict(pool="float32", q_dtype="float32"),
         dict(cap=50.0)),
        ("tiled window=256 f32", tiled, 8,
         dict(pool="float32", q_dtype="float32"), dict(window=256)),

        # The order-0 LUT steps by 0.54% at table boundaries, so a logit
        # one rounding apart can flip a table index: the plain version scans
        # one page per step in the kernel's splits, as the kernel does, over
        # integer q and k whose logits are exact on both sides.
        ("tiled lut0 f32", tiled, 8,
         dict(pool="float32", q_dtype="float32", exact_logits=True),
         dict(exp_mode="lut0", block_pages=1)),
        ("tiled exact f32", tiled, 8, dict(pool="float32", q_dtype="float32"),
         dict(exp_mode="exact")),
    ]
    # the served families' shapes (phase 11): lanes of 37 to 4,200 rows, a
    # chunk at 4,111 and a decode at 4,200, so gemma2's window of 4,096
    # masks keys whose edge falls inside a page
    fam = [(1, kv) for kv in FAMILY_KV_LENS]
    fam[-2] = (CHUNK, FAMILY_KV_LENS[-2])
    for fname, shape, kw in FAMILY_SHAPES:
        for pool in ("bfloat16", "int8"):
            cases.append((f"{fname} {pool}", fam, 8,
                          dict(pool=pool, n_pages=FAMILY_PAGES, **shape), kw))
    # phase 17's head band: a rank of deepseek-7b at mesh TP_RANKS holds
    # HQ / TP_RANKS of the heads, a head count #2 runs at nowhere else
    for pool in ("bfloat16", "int8"):
        cases.append((f"deepseek band {HQ // TP_RANKS}×{HQ // TP_RANKS}×{D} "
                      f"(mesh {TP_RANKS}) {pool}", tiled, 8,
                      dict(pool=pool, hq=HQ // TP_RANKS), {}))
    for i, (name, spec, bq, mk, kw) in enumerate(cases):
        s = make_stream(spec, seed=i, **mk)
        args = (s["q"], s["k"], s["v"], s["table"], s["pos"])
        for kv_split in (default_kv_split(s["k"].shape[2]), 1):
            kws = dict(dict(block_pages=8), **kw, cu_seqlens=s["cu"],
                       block_q=bq, k_scale=s["ks"], v_scale=s["vs"],
                       kv_split=kv_split)
            before = paged_attention.launches, paged_attention.combine_launches
            got = paged_attention_varlen(*args, **kws)
            torch.cuda.synchronize()
            if (paged_attention.launches, paged_attention.combine_launches) != (
                    before[0] + 1, before[1] + 1):
                fail(f"paged attention {name}: split pass and combine not "
                     f"launched once each")
            want = paged_attention_varlen_reference(*args, **kws)
            rows = slice(0, s["live"])               # dead rows are garbage
            g, w = got[rows], want[rows]
            if not torch.isfinite(got).all():
                fail(f"paged attention {name}: non-finite output")
            if got.dtype == torch.float32:
                err = float((g - w).abs().max())
                ok = torch.allclose(g, w, **F32_TOL)
                msg = f"max|Δ| {err:.3g} (atol 2e-5, rtol 1e-4)"
            else:
                err = bf16_ulps(g, w)
                ok = err <= 1.0
                msg = f"max {err:.2f} bf16 ulp beyond atol 2e-5 (limit 1)"
            log(f"[paged_attention] {name}, {kv_split} pages per split "
                f"({s['table'].shape[1]} table slots): {msg}")
            if not ok:
                fail(f"paged attention {name} at {kv_split} pages per split "
                     f"disagrees with the plain version: {msg}")


def phase7_lens():
    """Phase 7's prompt lengths, drawn from seed 0."""
    rng = np.random.default_rng(0)
    return rng, rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1, size=8)


def decode_kv_lens():
    """Phase 7's lanes halfway through their decode: the decode shape."""
    return [int(n) + MAX_NEW // 2 for n in phase7_lens()[1]]


def step_kind(prefill_tokens, decode_tokens) -> str:
    """A step's kind by its rows: decode only, prefill only, or mixed."""
    if not prefill_tokens:
        return "decode"
    return "mixed" if decode_tokens else "prefill"


def phase7_steps():
    """Phase 7's model steps as its scheduler packs them → (kinds, segments):
    per step its (prefill tokens, decode tokens, lanes), and its (new rows,
    KV rows after) per lane.  The scheduler reads the prompts' lengths and
    the engine's settings, never weights or token values (the prefix cache
    is off), so a deepseek-7b-smoke engine with phase 7's settings packs the
    same steps; ``main`` holds phase 7's own passes to these kinds."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.params import init_params
    from repro_torch.serving import EngineCore, Request
    cfg = get_config(MODEL + "-smoke")
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0), DEV)
    eng = EngineCore(cfg, params, device=DEV, capture=False, **ENGINE)
    for i, n in enumerate(phase7_lens()[1]):
        eng.submit(Request(uid=i, prompt=np.full(int(n), i, np.int32),
                           max_new=MAX_NEW))
    kinds, segments = [], []
    inner = eng.scheduler.batch_for

    def spy(wants):
        batch, pre = inner(wants)
        cu = batch.cu_seqlens
        if batch.plans:
            segments.append([(int(cu[i + 1] - cu[i]),
                              int(batch.pos[cu[i + 1] - 1]) + 1)
                             for i in range(len(batch.plans))])
        return batch, pre
    eng.scheduler.batch_for = spy
    while eng.scheduler.has_work():
        out = eng.step()
        if out.lanes:
            kinds.append((out.prefill_tokens, out.decode_tokens, out.lanes))
    if len(kinds) != len(segments):
        fail(f"phase 7's dry run: {len(kinds)} model steps, "
             f"{len(segments)} packed batches")
    return kinds, segments


def tuner_workloads(steps):
    """The tuner's traffic from phase 7's steps (``phase7_steps``): for each
    step kind, its middle step's segments, weighted by the number of phase
    7's steps of that kind → (workloads, weights)."""
    by_kind = {}
    for (pf, dc, _), seg in zip(*steps):
        by_kind.setdefault(step_kind(pf, dc), []).append(seg)
    return ({k: v[len(v) // 2] for k, v in by_kind.items()},
            {k: len(v) for k, v in by_kind.items()})


def spearman(a, b) -> float:
    """Rank correlation of two equal-length sequences (no ties expected)."""
    ra = np.argsort(np.argsort(a))
    rb = np.argsort(np.argsort(b))
    return float(np.corrcoef(ra, rb)[0, 1])


def phase_tuner(steps):
    """The kernel-config tuner on the card (phase 4a): for the bf16 and the
    int8 pool, every candidate of ``candidate_space(platform="cuda")`` and
    ``DEFAULT_CONFIG`` measured on kernel #2 (``tune(..., measure=True)``,
    which prunes nothing on the card) over phase 7's step kinds weighted by
    their counts (``tuner_workloads``), and held, step by step, against the
    plain version at its own block_q and pages per split (f32 atol 2e-5 /
    rtol 1e-4 → the bf16 output within one bf16 ulp beyond the atol, phase
    4's rule).  → per pool: the report, the winner, the default's and the
    winner's ms, the roofline's rank agreement; for the int8 pool also the
    bf16 pool's winner's ms (the table has one row per model and platform,
    as the reference's, so an int8 engine runs the bf16 winner)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.autotune import (DEFAULT_CONFIG, KernelConfig,
                                              config_kwargs, geom_for,
                                              synthetic_step, tune)
    from repro_torch.kernels.paged_attention import (
        paged_attention_varlen, paged_attention_varlen_reference)
    from repro_torch.kernels.paged_attention.ops import default_kv_split
    cfg = get_config(MODEL)
    wl, weights = tuner_workloads(steps)
    log(f"[tuner] phase 7's steps by kind {weights}; the middle step of "
        f"each: " + "; ".join(f"{k} {len(v)} lanes, (rows, KV rows) {v}"
                              for k, v in wl.items()))
    ps = ENGINE["page_size"]
    untagged = lambda d: {k: v for k, v in d.items() if k != "source"}  # noqa: E731
    out = {}
    for tag, quantized in (("bf16", False), ("int8", True)):
        geom = geom_for(cfg, page_size=ps, quantized=quantized)
        t0 = time.perf_counter()
        winner, report = tune(geom, platform="cuda", workloads=wl,
                              weights=weights, measure=True, iters=TUNE_ITERS)
        tune_s = time.perf_counter() - t0
        if any("measured_s" not in r for r in report):
            fail(f"tuner {tag}: a candidate was not measured")
        worst = 0.0
        built = {name: synthetic_step(seg, geom, DEV)     # drawn once a pool
                 for name, seg in wl.items()}
        for r in report:
            c = KernelConfig(**r["config"])
            for name, (args, kw) in built.items():
                kw = dict(kw, **config_kwargs(c))
                got = paged_attention_varlen(*args, **kw)
                want = paged_attention_varlen_reference(
                    *args, **dict(kw, kv_split=c.kv_split
                                  or default_kv_split(ps)))
                if not torch.isfinite(got).all():
                    fail(f"tuner {tag} {c.describe()} {name}: non-finite")
                ulps = bf16_ulps(got, want)
                worst = max(worst, ulps)
                if not ulps <= 1.0:
                    fail(f"tuner {tag}: {c.describe()} at the {name} step "
                         f"sits {ulps:.2f} bf16 ulp beyond atol 2e-5 from "
                         f"the plain version (limit 1)")
        pred = [r["predicted_s"] for r in report]
        meas = [r["measured_s"] for r in report]
        by_pred = int(np.argmin(pred))
        by_meas = int(np.argmin(meas))
        default = next(r for r in report
                       if r["config"] == DEFAULT_CONFIG.describe())
        rows = sorted(report, key=lambda r: r["measured_s"])
        for r in rows:
            c = r["config"]
            log(f"[tuner {tag}] block_q {c['block_q']:>2} pages/split "
                f"{str(c['kv_split']):>4}: predicted "
                f"{r['predicted_s'] * 1e3:.4f} ms, measured "
                f"{r['measured_s'] * 1e3:.4f} ms (sum over {weights}, min "
                f"of {TUNE_ITERS})")
        rank_of_pred_best = sorted(meas).index(meas[by_pred]) + 1
        facts = dict(
            winner=winner.describe(), tune_s=tune_s,
            winner_ms=meas[by_meas] * 1e3,
            default_ms=default["measured_s"] * 1e3,
            predicted_winner=report[by_pred]["config"],
            predicted_winner_measured_ms=meas[by_pred] * 1e3,
            predicted_winner_measured_rank=rank_of_pred_best,
            spearman=spearman(pred, meas), candidates=len(report),
            worst_bf16_ulps=worst,
            report=[dict(config=r["config"],
                         predicted_ms=r["predicted_s"] * 1e3,
                         measured_ms=r["measured_s"] * 1e3) for r in rows],
            workloads=wl, weights=weights)
        log(f"[tuner {tag}] winner {winner.describe()}: "
            f"{facts['winner_ms']:.4f} ms against DEFAULT_CONFIG's "
            f"{facts['default_ms']:.4f} ms "
            f"({facts['default_ms'] / facts['winner_ms']:.3f}×); the "
            f"roofline's pick {facts['predicted_winner']} measured "
            f"{facts['predicted_winner_measured_ms']:.4f} ms, rank "
            f"{rank_of_pred_best} of {len(report)}; Spearman ρ(predicted, "
            f"measured) {facts['spearman']:.3f}; every candidate within "
            f"{worst:.2f} bf16 ulp of its plain version (limit 1); "
            f"{tune_s:.1f} s; {CARD[0]}")
        out[tag] = facts
    bf16_winner = untagged(out["bf16"]["winner"])
    i8 = out["int8"]
    i8["bf16_winner_ms"] = next(r["measured_ms"] for r in i8["report"]
                                if untagged(r["config"]) == bf16_winner)
    log(f"[tuner int8] the bf16 pool's winner {bf16_winner}, which the table "
        f"gives int8 engines too: {i8['bf16_winner_ms']:.4f} ms against the "
        f"int8 pool's own winner's {i8['winner_ms']:.4f} ms and "
        f"DEFAULT_CONFIG's {i8['default_ms']:.4f} ms; {CARD[0]}")
    return out


def sa_inputs(shape, dtype, seed, integers=False):
    """q (B, Hq, Lq, D), k/v (B, Hkv, Lkv, D) drawn on the card from a seed;
    ``integers`` draws q and k as small integers, so every logit is exact."""
    import torch
    b, hq, hkv, lq, lkv, d = shape
    g = torch.Generator(device=DEV).manual_seed(seed)
    if integers:
        draw = lambda *s: torch.randint(-3, 4, s, generator=g,  # noqa: E731
                                        device=DEV).float()
    else:
        draw = lambda *s: torch.randn(s, generator=g, device=DEV)  # noqa: E731
    q, k = draw(b, hq, lq, d), draw(b, hkv, lkv, d)
    v = torch.randn((b, hkv, lkv, d), generator=g, device=DEV)
    dt = getattr(torch, dtype)
    return q.to(dt), k.to(dt), v.to(dt)


# (name, (B, Hq, Hkv, Lq, Lkv, D), dtype, kwargs): BERT-large widths at the
# paper's l and the top of its sweep, deepseek widths causal, then every
# option of the kernel at full width.
SA_CASES = [
    ("bert-large l512 f32", (8, 16, 16, 512, 512, 64), "float32", {}),
    ("bert-large l512 bf16", (8, 16, 16, 512, 512, 64), "bfloat16", {}),
    ("bert-large l4096 f32", (1, 16, 16, 4096, 4096, 64), "float32", {}),
    ("bert-large l4096 bf16", (1, 16, 16, 4096, 4096, 64), "bfloat16", {}),
    ("deepseek causal l2048 f32", (1, 32, 32, 2048, 2048, 128), "float32",
     dict(causal=True)),
    ("deepseek causal l2048 bf16", (1, 32, 32, 2048, 2048, 128), "bfloat16",
     dict(causal=True)),
    ("gqa 4:1 causal bf16", (2, 32, 8, 1024, 1024, 128), "bfloat16",
     dict(causal=True)),
    ("window 256 causal f32", (1, 32, 32, 2048, 2048, 128), "float32",
     dict(causal=True, window=256)),
    ("softcap 50 f32", (2, 16, 16, 512, 512, 64), "float32", dict(cap=50.0)),
    ("q_offset 1000 kv_len 1290 gqa f32", (2, 32, 8, 300, 1400, 128),
     "float32", dict(causal=True, q_offset=1000, kv_len=1290)),
    ("ragged Lq 1000 Lkv 1037 gqa f32", (3, 16, 4, 1000, 1037, 64), "float32",
     {}),
    ("rows that see no key f32", (1, 16, 16, 200, 512, 64), "float32",
     dict(causal=True, q_offset=560, window=100)),
    ("exact l512 f32", (8, 16, 16, 512, 512, 64), "float32",
     dict(exp_mode="exact")),
    ("exact causal l2048 bf16", (1, 32, 32, 2048, 2048, 128), "bfloat16",
     dict(causal=True, exp_mode="exact")),
    # The order-0 LUT depends on the online-softmax blocking and a logit one
    # rounding apart can flip a table index: held against the plain scan at
    # the kernel's 64-key tiles over integer q and k (exact logits, in bf16
    # too).
    ("lut0 l512 f32", (8, 16, 16, 512, 512, 64), "float32",
     dict(exp_mode="lut0")),
    ("lut0 causal l2048 f32", (1, 32, 32, 2048, 2048, 128), "float32",
     dict(causal=True, exp_mode="lut0")),
]
# bf16 twins of the f32-only cases: the tensor-core kernel on every option
SA_CASES += [(name[:-len(" f32")] + " bf16", shape, "bfloat16", kw)
             for name, shape, dtype, kw in SA_CASES[7:]
             if dtype == "float32"]
# Head dim 256 at gemma2's widths (16 × 8 heads, softcap 50): a 4,200-row
# causal query that the window of 4,096 bites, over 4,224 keys of which
# kv_len keeps 4,150; both kernels, the LUT and the exact exponential.
GEMMA2_D256 = (1, 16, 8, 4200, 4224, 256)
GEMMA2_KW = dict(causal=True, cap=50.0, window=4096, kv_len=4150)
SA_CASES += [(f"gemma2 d256 window 4096 kv_len 4150 {exp} {dt}", GEMMA2_D256,
              dtype, dict(GEMMA2_KW, exp_mode=exp))
             for exp in ("lut", "exact")
             for dt, dtype in (("f32", "float32"), ("bf16", "bfloat16"))]
# The MoE family's scoring shapes (2 × 1024, causal): granite-moe-3b-a800m's
# 24 × 8 heads of 64 (GQA 3:1) and grok-1-314b's 48 × 8 of 128 (GQA 6:1,
# softcap 30), both kernels.
SA_CASES += [(f"{model} causal l1024 {dt}", shape, dtype, dict(causal=True, **kw))
             for model, shape, kw in (
                 ("granite gqa 3:1", (2, 24, 8, 1024, 1024, 64), {}),
                 ("grok gqa 6:1 cap 30", (2, 48, 8, 1024, 1024, 128),
                  dict(cap=30.0)))
             for dt, dtype in (("f32", "float32"), ("bf16", "bfloat16"))]
# zamba2-1.2b's shared attention block as its slot prefill runs it: one
# prompt of 1,024 tokens, 32 heads of 64 (MHA), causal, both kernels.
ZAMBA2_PREFILL = (1, 32, 32, 1024, 1024, 64)
SA_CASES += [(f"zamba2 shared prefill causal l1024 {dt}", ZAMBA2_PREFILL,
              dtype, dict(causal=True))
             for dt, dtype in (("f32", "float32"), ("bf16", "bfloat16"))]
# Phase 15's calls: internvl2-1b's multimodal prefill (8 × (256 patches +
# 128 tokens) over its cache of 416 rows, kv_len 384, 14 × 2 heads of 64,
# GQA 7:1, causal), seamless-m4t's encoder
# (8 × 256 frames, 16 × 64, bidirectional), its decoder's self-attention in
# the prefill (16 rows over the 48-row cache, kv_len 16, causal) and its
# cross-attention (16 rows against 256 frames, Lq ≠ Lkv, no mask), and the
# cross-attention of its scoring batch (1,024 rows against 256 frames).
VLM_PREFILL = (VLM_BATCH, 14, 2, 256 + VLM_PROMPT,
               256 + VLM_PROMPT + GEN_NEW, 64)
ENCDEC_SHAPES = (
    ("internvl2 prefix prefill (GQA 7:1)", VLM_PREFILL,
     dict(causal=True, kv_len=256 + VLM_PROMPT)),
    ("seamless encoder", (ENCDEC_BATCH, 16, 16, 256, 256, 64), {}),
    ("seamless decoder self-attention prefill",
     (ENCDEC_BATCH, 16, 16, ENCDEC_PROMPT, ENCDEC_PROMPT + GEN_NEW, 64),
     dict(causal=True, kv_len=ENCDEC_PROMPT)),
    ("seamless cross-attention prefill",
     (ENCDEC_BATCH, 16, 16, ENCDEC_PROMPT, 256, 64), {}))
SA_CASES += [(f"{name} {dt}", shape, dtype, kw)
             for name, shape, kw in ENCDEC_SHAPES + (
                 ("seamless cross-attention scoring",
                  (ENCDEC_SCORE[0], 16, 16, ENCDEC_SCORE[1], 256, 64), {}),)
             for dt, dtype in (("f32", "float32"), ("bf16", "bfloat16"))]
# the kernel each dtype launches (ops.kernel_variant)
VARIANT = {"float32": "cuda_core", "bfloat16": "tensor_core"}


def phase_streaming_attention():
    """Kernel #3 against its plain version on every case of ``SA_CASES``:
    f32 within the reference kernel suite's atol 3e-5 / rtol 1e-4, bf16
    within one bf16 ulp beyond that atol and, against the f32 plain
    version, within ``PV_LIMITS`` (lut0 excepted: its plain scan is held
    bit-close at the kernel's blocking instead); each launch counted under
    the kernel its dtype selects (bf16: tensor cores, f32: CUDA cores)."""
    import torch
    from repro_torch.core.streaming_attention import (
        streaming_attention as attention_scan)
    from repro_torch.kernels.streaming_attention import (attention_ref,
                                                         streaming_attention)
    from repro_torch.kernels.streaming_attention.ops import BLOCK_K
    worst = {}
    for i, (name, shape, dtype, kw) in enumerate(SA_CASES):
        lut0 = kw.get("exp_mode") == "lut0"
        q, k, v = sa_inputs(shape, dtype, seed=100 + i, integers=lut0)
        before = streaming_attention.launches
        by = dict(streaming_attention.launches_by_variant)
        got = streaming_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        by[VARIANT[dtype]] += 1
        if (streaming_attention.launches != before + 1
                or streaming_attention.launches_by_variant != by):
            fail(f"streaming attention {name}: the {VARIANT[dtype]} kernel "
                 f"was not launched once ({streaming_attention.launches_by_variant})")
        want32 = None if lut0 else attention_ref(q.float(), k.float(),
                                                 v.float(), **kw)
        want = (attention_scan(q, k, v, block_k=BLOCK_K, **kw) if lut0
                else want32.to(q.dtype))
        if got.shape != want.shape or not torch.isfinite(got).all():
            fail(f"streaming attention {name}: shape {tuple(got.shape)} or "
                 f"non-finite output")
        if "window" in kw and "q_offset" in kw:        # rows past the keys
            blind = torch.arange(shape[3], device=DEV) + kw["q_offset"] \
                - kw["window"] + 1 >= shape[4]
            if got[:, :, blind].any():
                fail(f"streaming attention {name}: a row that sees no key "
                     f"is not 0")
        if got.dtype == torch.float32:
            err = float((got - want).abs().max())
            ok = torch.allclose(got, want, **SA_TOL)
            msg = f"max|Δ| {err:.3g} (atol 3e-5, rtol 1e-4)"
        else:
            err = bf16_ulps(got, want, SA_TOL["atol"])
            ok = err <= 1.0
            msg = f"max {err:.2f} bf16 ulp beyond atol 3e-5 (limit 1)"
            if not lut0:
                pv = bf16_pv_precision(got, want32)
                ok = ok and pv_precision_ok(pv)
                msg += (f"; against f32: rms {pv['rms_ratio']:.4f}× the "
                        f"rounding's (limit {PV_LIMITS['rms_ratio']}), bias "
                        f"{pv['bias']:.2e} (limit ±2^-12)")
        worst[name] = err
        log(f"[streaming_attention] {name}: {msg}")
        if not ok:
            fail(f"streaming attention {name} disagrees with the plain "
                 f"version: {msg}")
        del q, k, v, got, want, want32
    torch.cuda.empty_cache()
    return worst


def reset_streaming_counts():
    from repro_torch.kernels.streaming_attention import streaming_attention
    streaming_attention.launches = 0
    for v in streaming_attention.launches_by_variant:
        streaming_attention.launches_by_variant[v] = 0


def expect_variant(label, variant, n):
    """Since the last reset, kernel #3 launched ``n`` times, all of them
    the ``variant`` kernel."""
    from repro_torch.kernels.streaming_attention import streaming_attention
    by = streaming_attention.launches_by_variant
    want = {v: (n if v == variant else 0) for v in by}
    log(f"[{label}] streaming attention launches by kernel: {by}")
    if by != want:
        fail(f"{label}: streaming attention launches by kernel {by}, "
             f"expected {want}")


def hold_logits(label, k_logits, p_logits, p2_logits, floor):
    """Kernel logits against the plain attention's, with the serving step's
    margin rule (``phase_step_vs_plain``):
    the kernel must sit within 3× the spread between two plain schedules
    (materialised logits and the online-softmax scan) on this very input,
    ``floor`` at least; greedy picks must agree on every row whose top-2
    margin exceeds twice the measured gap."""
    import torch
    for lg in (k_logits, p_logits, p2_logits):
        if not torch.isfinite(lg).all():
            fail(f"{label}: non-finite logits")
    err = float((k_logits - p_logits).abs().max())
    spread = float((p2_logits - p_logits).abs().max())
    tol = max(3.0 * spread, floor)
    flat_p = p_logits.reshape(-1, p_logits.shape[-1])
    top2 = torch.topk(flat_p, 2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    agree = (k_logits.reshape(flat_p.shape).argmax(-1) == flat_p.argmax(-1))
    decided = margin > 2 * err
    log(f"[{label}] kernel vs plain attention max|Δlogit| {err:.3g}; plain "
        f"materialised vs scan {spread:.3g} (limit {tol:.3g}); logit std "
        f"{float(p_logits.std()):.3f}; argmax agrees on "
        f"{int(agree.sum())}/{agree.numel()} rows, all {int(decided.sum())} "
        f"rows with a top-2 margin > 2×max|Δ| must")
    if err > tol:
        fail(f"{label}: logits differ by {err} > {tol}")
    if not agree[decided].all():
        fail(f"{label}: argmax differs on a row with a clear margin")
    return dict(max_abs_logit=err, plain_spread=spread, limit=tol,
                rows=agree.numel(), agree=int(agree.sum()),
                decided=int(decided.sum()))


def hold_loss(label, losses, floor):
    """(kernel, materialised plain, plain scan) losses: the kernel within 3×
    the plain schedules' spread, ``floor`` at least."""
    k, p, p2 = losses
    err, spread = abs(k - p), abs(p2 - p)
    tol = max(3.0 * spread, floor)
    log(f"[{label}] kernel {k:.6f}, plain {p:.6f}, plain scan {p2:.6f}: "
        f"|Δ| {err:.3g} (limit {tol:.3g})")
    if not np.isfinite(losses).all() or err > tol:
        fail(f"{label}: kernel {k} vs plain {p} (limit {tol})")
    return dict(kernel=k, plain=p, plain_scan=p2, limit=tol)


def logits_three_ways(cfg, params, tokens, causal):
    """``lm_apply`` logits through the kernel (``auto``), the materialised
    plain attention (``naive``) and the plain scan (``jnp``)."""
    from repro_torch.models.lm import lm_apply
    return [lm_apply(cfg.replace(attn_backend=b), params, tokens,
                     causal=causal) for b in ("auto", "naive", "jnp")]


def phase_bert():
    """BERT-large at full width and depth: encode 8 × 512 and 1 × 4096
    tokens through ``build_model(cfg).prefill`` (24 kernel launches per
    forward), the masked-LM loss, and the logits held against the plain
    attention in bf16 and f32."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.streaming_attention import streaming_attention
    from repro_torch.models.api import build_model
    cfg = get_config(BERT)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=DEV).manual_seed(1), DEV)
    torch.cuda.synchronize()
    n_bytes = sum(p.numel() * p.element_size() for p in params.values())
    log(f"[weights] {cfg.name}: {sum(p.numel() for p in params.values()) / 1e6:.1f}"
        f" M parameters, {n_bytes / 1e9:.2f} GB {cfg.dtype}, drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(1)
    facts = {"launches": 0, "forwards": {}}
    for b, l in BERT_SHAPES:
        tokens = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (b, l)).astype(np.int32)).to(DEV)
        batch = {"tokens": tokens}
        model.prefill(params, batch)                  # warm: cuBLAS plans
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_streaming_counts()
        paged_attention.launches = 0
        logits, _ = model.prefill(params, batch)
        torch.cuda.synchronize()
        launches = streaming_attention.launches
        if launches != cfg.num_layers or paged_attention.launches:
            fail(f"bert encode {b}×{l}: streaming attention launched "
                 f"{launches} times (expected {cfg.num_layers}), paged "
                 f"{paged_attention.launches}")
        expect_variant(f"bert encode {b}×{l}", "tensor_core", cfg.num_layers)
        if logits.shape != (b, l, cfg.vocab_size) or not torch.isfinite(
                logits).all():
            fail(f"bert encode {b}×{l}: logits {tuple(logits.shape)} not "
                 f"finite")
        facts["launches"] += launches
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        walls = []
        for _ in range(5):                            # host clock, synced
            t0 = time.perf_counter()
            model.prefill(params, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        wall = float(np.median(walls))
        f = dict(ms=wall * 1e3, ms_all=[w * 1e3 for w in walls],
                 tok_s=b * l / wall, launches=launches, peak_gib=peak)
        log(f"[bert encode {b}×{l}] median of 5 forwards {f['ms']:.1f} ms "
            f"(earlier: {EARLIER_MS[f'bert {b}x{l}']} ms) → "
            f"{f['tok_s']:.0f} tokens/s; peak {peak:.2f} GiB; "
            f"streaming_attention launches {launches} in the counted forward")
        f["bf16"] = hold_logits(f"bert {b}×{l} bf16", *logits_three_ways(
            cfg, params, tokens, causal=False), floor=1e-2)
        facts["forwards"][f"{b}x{l}"] = f
        del logits
    # the masked-LM loss on the 8 × 512 batch: 15% of positions masked
    b, l = BERT_SHAPES[0]
    tokens = rng.integers(0, cfg.vocab_size, (b, l)).astype(np.int32)
    masked = rng.random((b, l)) < 0.15
    batch = {"tokens": torch.from_numpy(np.where(masked, MASK_ID, tokens)
                                        .astype(np.int32)).to(DEV),
             "labels": torch.from_numpy(tokens).to(DEV),
             "loss_mask": torch.from_numpy(masked.astype(np.float32)).to(DEV)}
    reset_streaming_counts()
    losses = [float(build_model(cfg.replace(attn_backend=be)).loss(
        params, batch)[0]) for be in ("auto", "naive", "jnp")]
    if streaming_attention.launches != cfg.num_layers:
        fail("bert loss did not run through the kernel")
    expect_variant("bert loss", "tensor_core", cfg.num_layers)
    facts["mlm_loss"] = hold_loss("bert MLM loss", losses, floor=1e-3)
    log(f"[bert loss] masked-LM loss on {b}×{l} ({int(masked.sum())} masked): "
        f"{losses[0]:.4f} through the kernel, {losses[1]:.4f} plain (ln V = "
        f"{np.log(cfg.vocab_size):.4f})")
    # f32: the same weights widened
    c32 = cfg.replace(dtype="float32")
    p32 = {k: v.float() for k, v in params.items()}
    del params
    for b, l in BERT_SHAPES:
        tokens = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (b, l)).astype(np.int32)).to(DEV)
        reset_streaming_counts()
        three = logits_three_ways(c32, p32, tokens, causal=False)
        expect_variant(f"bert {b}×{l} f32", "cuda_core", cfg.num_layers)
        facts["forwards"][f"{b}x{l}"]["f32"] = hold_logits(
            f"bert {b}×{l} f32", *three, floor=1e-3)
        del three
    del p32
    torch.cuda.empty_cache()
    return facts


def bits_equal(a, b) -> bool:
    """Equal shapes, dtypes and bits (f32 through int32, bf16 through
    int16)."""
    import torch
    view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.view(view), b.view(view))


# (leading dims, K, N, x dtype): the reference kernel suite's shapes, its
# batched case, M = 1 and 8 at BERT-large widths, ragged K (byte staging;
# K % 16 ≠ 0 runs mma.sync only; 208 and 48 are whole TMA rows but not
# whole 128-byte stages) and N (masked and scalar stores)
INT8_CASES = [((64,), 256, 128, "float32"), ((17,), 300, 130, "float32"),
              ((4,), 128, 512, "float32"), ((257,), 1024, 384, "float32"),
              ((1,), 128, 128, "float32"), ((2, 3), 256, 64, "float32"),
              ((1,), 1024, 4096, "bfloat16"), ((8,), 4096, 1024, "bfloat16"),
              ((257,), 1024, 384, "bfloat16"), ((33,), 200, 96, "float32"),
              ((130,), 256, 100, "bfloat16"), ((70,), 208, 260, "bfloat16"),
              ((5,), 48, 20, "float32")]


# the quantisation kernel's cases: (name, shape, bits); "ties" holds exact
# .5 quotients (absmax 127 → scale 1), "outlier" one value 10^4 times the
# rest, "unaligned" a start off the 16-byte grid (element-wise path)
QUANT_CASES = [("ragged", (257, 131), 8), ("ragged", (7,), 8),
               ("ragged", (3, 5, 11), 8), ("unaligned", (4098,), 8),
               ("zeros", (64, 48), 8), ("ties", (96, 40), 8),
               ("outlier", (512, 64), 8), ("bits4", (33, 77), 4),
               ("bert", (8, 512, 1024), 8)]


def quant_input(name, shape, dt, g):
    import torch
    if name == "zeros":
        return torch.zeros(shape, device=DEV, dtype=dt)
    if name == "ties":
        x = torch.randint(-126, 126, shape, generator=g, device=DEV).float() + 0.5
        x[0, 0] = 127.0
        return x.to(dt)
    x = torch.randn((shape[0] + 1,) if name == "unaligned" else shape,
                    generator=g, device=DEV) * 3
    if name == "outlier":
        x[100, 7] = -3.0e4
    x = x.to(dt)
    return x[1:] if name == "unaligned" else x


def phase_quantize_checks():
    """The activation quantisation kernel against its plain version, bit
    for bit (int8 values and the f32 scale), f32 and bf16."""
    import torch
    from repro_torch.core import quant
    g = torch.Generator(device=DEV).manual_seed(23)
    checked = 0
    for name, shape, bits in QUANT_CASES:
        for dt in (torch.float32, torch.bfloat16):
            x = quant_input(name, shape, dt, g)
            before = quant.quantize_dynamic.launches
            got = quant.quantize_dynamic(x, bits=bits)
            want = quant._quantize(x, torch.amax(torch.abs(x.to(torch.float32))),
                                   bits)
            torch.cuda.synchronize()
            if quant.quantize_dynamic.launches != before + 1:
                fail(f"quantize_dynamic {name} {shape}: kernel not launched")
            if not (torch.equal(got.values, want.values) and got.scale.shape == ()
                    and bits_equal(got.scale, want.scale)):
                fail(f"quantize_dynamic {name} {shape} {dt} bits {bits}: not "
                     f"bit-equal to the plain version (scale {float(got.scale)!r}"
                     f" vs {float(want.scale)!r})")
            if name == "ties" and float(got.scale) != 1.0:
                fail(f"quantize_dynamic ties: scale {float(got.scale)} != 1")
            checked += 1
    log(f"[quantize_dynamic] bit-equal to the plain version (int8 values and "
        f"scale) in {checked} cases: ragged and unaligned sizes, all zeros, "
        f".5 ties, an outlier, bits=4, f32 and bf16")


def int8_both_layouts(wv):
    """w as ``quantize(w, axis=0)`` stores it (K-major) and row-major."""
    return {"k_major": wv.t().contiguous().t(), "row": wv.contiguous()}


def phase_int8_checks():
    """Kernel #4 against its plain version, bit for bit: the f32 output of
    the public wrapper and, through the 2-D entry, the int32 accumulator;
    each variant the shape allows (wgmma where K % 16 == 0, mma.sync
    always), on both weight layouts."""
    import torch
    from repro_torch.core.quant import quantize, quantize_dynamic
    from repro_torch.kernels.int8_matmul import (int8_matmul, int8_matmul_2d,
                                                 int8_matmul_2d_ref,
                                                 int8_matmul_ref)
    phase_quantize_checks()
    g = torch.Generator(device=DEV).manual_seed(13)
    by_variant = {"wgmma": 0, "mma_sync": 0}
    for lead, k, n, dt in INT8_CASES:
        x = torch.randn((*lead, k), generator=g, device=DEV).to(getattr(torch, dt))
        wq = quantize(torch.randn((k, n), generator=g, device=DEV), axis=0)
        before = int8_matmul.launches
        got = int8_matmul(x, wq)
        torch.cuda.synchronize()
        if int8_matmul.launches != before + 1:
            fail(f"int8_matmul {lead}×{k}×{n}: kernel not launched")
        if not bits_equal(got, int8_matmul_ref(x, wq)):
            fail(f"int8_matmul {lead}×{k}×{n} {dt}: not bit-equal to the "
                 f"plain version")
        xq = quantize_dynamic(x)
        xv = xq.values.reshape(-1, k)
        ref, ref_acc = int8_matmul_2d_ref(xv, wq.values, xq.scale, wq.scale,
                                          with_acc=True)
        variants = ("wgmma", "mma_sync") if k % 16 == 0 else ("mma_sync",)
        for variant in variants:
            for lay, wv in int8_both_layouts(wq.values).items():
                out, acc = int8_matmul_2d(xv, wv, xq.scale, wq.scale,
                                          with_acc=True, variant=variant)
                by_variant[variant] += 1
                if not (torch.equal(acc, ref_acc) and bits_equal(out, ref)):
                    fail(f"int8_matmul {lead}×{k}×{n} {dt} {variant}, w {lay}: "
                         f"not bit-equal to the plain version (max|Δacc| "
                         f"{int((acc.long() - ref_acc.long()).abs().max())})")
    # all-±127 operands: |acc| past 2^24, where int→f32 rounds
    k, n = 4096, 1024
    xv = torch.where(torch.rand((256, k), generator=g, device=DEV) < 0.9, 127,
                     -127).to(torch.int8)
    wv = torch.where(torch.rand((k, n), generator=g, device=DEV) < torch.linspace(
        0.5, 1.0, n, device=DEV), 127, -127).to(torch.int8)
    xs = torch.full((), 0.01, device=DEV)
    ws = torch.rand((1, n), generator=g, device=DEV) + 0.5
    ref, ref_acc = int8_matmul_2d_ref(xv, wv, xs, ws, with_acc=True)
    big = int(ref_acc.abs().max())
    for variant in ("wgmma", "mma_sync"):
        for lay, w in int8_both_layouts(wv).items():
            out, acc = int8_matmul_2d(xv, w, xs, ws, with_acc=True,
                                      variant=variant)
            by_variant[variant] += 1
            if big <= 2 ** 24 or not (torch.equal(acc, ref_acc)
                                      and bits_equal(out, ref)):
                fail(f"int8_matmul ±127 {variant}, w {lay}: max|acc| {big}, "
                     f"not bit-equal to the plain version")
    log(f"[int8_matmul] bit-equal to the plain version (accumulators and f32 "
        f"outputs) in {len(INT8_CASES) + 1} cases, {by_variant} calls per "
        f"variant over both weight layouts; ±127 operands reach |acc| = "
        f"{big} > 2^24")


def phase_int8_bert():
    """The INT8 path at BERT-large width and depth: the 144 projection
    weights quantised per output channel (K-major values), real activations
    of 8 × 512 tokens (the layer-norm'd embeddings for the K = 1024
    products, the GELU of up's int8 output for down) through
    ``dense_maybe_quant``.  Counts zeroed just before the pass and read just
    after: the quantisation kernel, #4 by variant and by (M, K, N), and the
    weight transposes; then every output held bit-exactly to the plain
    version (through the 2-D entry for the int32 accumulators, launches
    outside the counted pass) and against the bf16 product in f32.  The
    pass is timed whole and by part (host clock around work that ends in a
    sync, medians of 5): the 144 quantisations alone on the pass's own
    activations, the 144 products alone on activations quantised
    beforehand, and the 24 GELUs; and its host time alone (``host_ms``: the
    pass enqueued behind a spin, no sync)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.core import quant
    from repro_torch.core.quant import dense_maybe_quant, quantize, quantize_dynamic
    from repro_torch.kernels.int8_matmul import (int8_matmul, int8_matmul_2d,
                                                 int8_matmul_2d_ref)
    from repro_torch.models.layers import embed_full, layer_norm_apply
    from repro_torch.params import init_params
    from repro_torch.serving.graphs import CapturedCall
    cfg = get_config(BERT)
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(1), DEV)
    t0 = time.perf_counter()
    qw = {(key, i): quantize(params[key][i], axis=0)
          for i in range(cfg.num_layers) for key in INT8_PROJ}
    torch.cuda.synchronize()
    quant_ms = (time.perf_counter() - t0) * 1e3
    if not all(q.values.stride() == (1, q.values.shape[0]) for q in qw.values()):
        fail("int8 bert: quantize(w, axis=0) did not store the weights K-major")
    b, l = INT8_TOKENS
    rng = np.random.default_rng(13)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, l))
                              .astype(np.int32)).to(DEV)
    x = layer_norm_apply(params["ln1"][0], params["ln1_b"][0], embed_full(
        cfg, params, tokens, torch.arange(l, device=DEV)))
    dt = x.dtype

    def project(inp, wq, by_shape):
        before = int8_matmul.launches
        y = dense_maybe_quant(inp, wq)
        if by_shape is not None:
            mkn = f"{inp.numel() // inp.shape[-1]}x{wq.shape[0]}x{wq.shape[1]}"
            by_shape[mkn] = by_shape.get(mkn, 0) + int8_matmul.launches - before
        return y

    def forward_projections(by_shape=None):
        outs = {}
        for i in range(cfg.num_layers):
            for key in INT8_PROJ[:5]:
                outs[key, i] = (x, project(x, qw[key, i], by_shape))
            h = F.gelu(outs["up", i][1], approximate="tanh").to(dt)
            outs["down", i] = (h, project(h, qw["down", i], by_shape))
        return outs

    forward_projections()                             # warm
    torch.cuda.synchronize()
    by_shape = {}
    int8_matmul.launches = 0
    int8_matmul.launches_by_variant.update(wgmma=0, mma_sync=0)
    int8_matmul.transposes = 0
    quant.quantize_dynamic.launches = 0
    t0 = time.perf_counter()
    outs = forward_projections(by_shape)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = int8_matmul.launches
    counts = dict(int8_matmul=launches,
                  by_variant=dict(int8_matmul.launches_by_variant),
                  transposes=int8_matmul.transposes,
                  quantize_dynamic=quant.quantize_dynamic.launches)
    if (launches != len(qw) or sum(by_shape.values()) != launches
            or counts["by_variant"] != {"wgmma": len(qw), "mma_sync": 0}
            or counts["transposes"] != 0
            or counts["quantize_dynamic"] != len(qw)):
        fail(f"int8 bert pass: launches {counts} ({by_shape}), expected "
             f"{len(qw)} quantisations, {len(qw)} wgmma products, 0 mma.sync, "
             f"0 transposes")

    def synced_ms(fn):                                # host clock, synced
        fn()
        torch.cuda.synchronize()
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        return walls

    walls = synced_ms(forward_projections)
    pass_host_ms = host_ms(forward_projections, calls=1)
    inputs = [(inp, qw[k]) for k, (inp, _) in outs.items()]
    quant_walls = synced_ms(lambda: [quantize_dynamic(inp) for inp, _ in inputs])
    pre = [(quantize_dynamic(inp), wq) for inp, wq in inputs]
    pre = [(xq.values.reshape(-1, wq.shape[0]), xq.scale, wq) for xq, wq in pre]
    kernel_walls = synced_ms(lambda: [int8_matmul_2d(xv, wq.values, xs, wq.scale)
                                      for xv, xs, wq in pre])
    ups = [outs["up", i][1] for i in range(cfg.num_layers)]
    gelu_walls = synced_ms(lambda: [F.gelu(u, approximate="tanh").to(dt)
                                    for u in ups])
    xd, wd = inputs[0]
    call_host_ms = host_ms(lambda: dense_maybe_quant(xd, wd))
    del pre, ups, inputs

    def forward_bf16():
        for i in range(cfg.num_layers):
            for key in INT8_PROJ[:5]:
                y = dense_maybe_quant(x, params[key][i])
            dense_maybe_quant(F.gelu(y, approximate="tanh"), params["down"][i])

    bf16_walls = synced_ms(forward_bf16)

    worst = {key: 0.0 for key in INT8_PROJ}
    for (key, i), (inp, y) in outs.items():
        wq = qw[key, i]
        xq = quantize_dynamic(inp)
        xv = xq.values.reshape(-1, inp.shape[-1])
        out, acc = int8_matmul_2d(xv, wq.values, xq.scale, wq.scale,
                                  with_acc=True)
        ref, ref_acc = int8_matmul_2d_ref(xv, wq.values, xq.scale, wq.scale,
                                          with_acc=True)
        if not (torch.equal(acc, ref_acc) and bits_equal(out, ref)
                and bits_equal(y.reshape(ref.shape), ref)):
            fail(f"int8 bert {key}[{i}]: not bit-equal to the plain version")
        full = torch.matmul(inp.float(), params[key][i].float())
        rel = float(torch.linalg.norm(y - full) / torch.linalg.norm(full))
        worst[key] = max(worst[key], rel)
        if not y.isfinite().all() or y.shape != (b, l, wq.values.shape[1]):
            fail(f"int8 bert {key}[{i}]: output {tuple(y.shape)} not finite")
    if max(worst.values()) >= INT8_REL_TOL:
        fail(f"int8 bert: relative error to the bf16 product {worst} >= "
             f"{INT8_REL_TOL}")
    # The same pass captured once as a CUDA graph (a measurement: no model
    # path replays it), its replay held bit-equal to the eager outputs and
    # its launches counted through the capture's recorded counts.
    t0 = time.perf_counter()
    cap = CapturedCall(forward_projections, torch.device(DEV))
    torch.cuda.synchronize()
    capture_ms = (time.perf_counter() - t0) * 1e3
    int8_matmul.launches = 0
    int8_matmul.launches_by_variant.update(wgmma=0, mma_sync=0)
    quant.quantize_dynamic.launches = 0
    replayed = cap.replay()
    torch.cuda.synchronize()
    graph_counts = dict(int8_matmul=int8_matmul.launches,
                        by_variant=dict(int8_matmul.launches_by_variant),
                        quantize_dynamic=quant.quantize_dynamic.launches)
    if graph_counts != dict(int8_matmul=len(qw), quantize_dynamic=len(qw),
                            by_variant={"wgmma": len(qw), "mma_sync": 0}):
        fail(f"int8 bert graph: one replay counted {graph_counts}")
    for key, (_, y) in outs.items():
        if not bits_equal(replayed[key][1], y):
            fail(f"int8 bert graph {key}: the replay is not bit-equal to the "
                 f"eager pass")
    graph_walls = synced_ms(cap.replay)
    del cap, replayed
    med = lambda w: float(np.median(w))  # noqa: E731
    facts = dict(launches=launches, launches_by_shape=by_shape, counts=counts,
                 weights=len(qw), quantize_ms=quant_ms, first_pass_ms=wall_ms,
                 ms=med(walls), ms_all=walls, host_ms=pass_host_ms,
                 quantize_dynamic_ms=med(quant_walls),
                 kernels_only_ms=med(kernel_walls), gelu_ms=med(gelu_walls),
                 call_host_ms=call_host_ms, bf16_ms=med(bf16_walls),
                 rel_err_vs_bf16=worst, graph_ms=med(graph_walls),
                 graph_ms_all=graph_walls, graph_capture_ms=capture_ms,
                 graph_counts=graph_counts)
    log(f"[int8 bert] {len(qw)} projection weights quantised (K-major) in "
        f"{quant_ms:.0f} ms; over {b}×{l} tokens: {counts} "
        f"({by_shape}), every output and accumulator bit-equal to the plain "
        f"version; the {len(qw)} projections take {facts['ms']:.2f} ms "
        f"(median of 5, host clock, synced), their host work alone "
        f"{pass_host_ms:.2f} ms; by part (synced): the {len(qw)} "
        f"quantisations {facts['quantize_dynamic_ms']:.2f} ms, the "
        f"{len(qw)} products on pre-quantised inputs "
        f"{facts['kernels_only_ms']:.2f} ms, the {cfg.num_layers} GELUs "
        f"{facts['gelu_ms']:.2f} ms; one dense_maybe_quant call's host time "
        f"{call_host_ms:.4f} ms; bf16 {facts['bf16_ms']:.2f} ms; worst "
        f"relative error to the bf16 product "
        + ", ".join(f"{k} {v:.4f}" for k, v in worst.items())
        + f" (limit {INT8_REL_TOL}); captured as one CUDA graph "
        f"({capture_ms:.0f} ms to capture): a replay takes "
        f"{facts['graph_ms']:.2f} ms (median of 5, synced) against the eager "
        f"pass's {facts['ms']:.2f}, bit-equal, counting {graph_counts}")
    del params, qw, outs, x
    torch.cuda.empty_cache()
    return facts


def phase_scoring(cfg, params, label, floor):
    """Causal scoring (``build_model(cfg).loss``) on 2 × 1024 tokens
    (deepseek-7b in phase 7, starcoder2-3b in phase 11): one kernel launch
    per layer, the loss and the logits held against the plain
    attention."""
    import torch
    from repro_torch.kernels.streaming_attention import streaming_attention
    from repro_torch.models.api import build_model
    b, l = SCORE_SHAPE
    rng = np.random.default_rng(5)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, l))
                              .astype(np.int32)).to(DEV)
    reset_streaming_counts()
    t0 = time.perf_counter()
    loss = float(build_model(cfg).loss(params, {"tokens": tokens})[0])
    wall = time.perf_counter() - t0
    launches = streaming_attention.launches
    if launches != cfg.num_layers:
        fail(f"{cfg.name} scoring {label}: streaming attention launched "
             f"{launches} times, expected {cfg.num_layers}")
    expect_variant(f"{cfg.name} scoring {label}", VARIANT[cfg.dtype],
                   cfg.num_layers)
    losses = [loss] + [float(build_model(cfg.replace(attn_backend=be)).loss(
        params, {"tokens": tokens})[0]) for be in ("naive", "jnp")]
    log(f"[scoring {label}] {cfg.name} next-token loss on {b}×{l}: {loss:.4f} "
        f"through the kernel ({launches} launches, {wall * 1e3:.0f} ms incl. "
        f"the first call), {losses[1]:.4f} plain (ln V = "
        f"{np.log(cfg.vocab_size):.4f})")
    held = hold_logits(f"scoring {label}", *logits_three_ways(
        cfg, params, tokens, causal=True), floor=floor)
    if cfg.family == "moe":
        # the loss is ce + router_aux_weight · aux: each part held apart.
        # In bf16 a rounding apart moves a router probability across a
        # near-tie and the routing then differs in that layer, so two
        # plain schedules' spread undersamples how far bf16 runs part:
        # held instead against the f32 plain run (``hold_moe_losses``)
        parts = [build_model(cfg.replace(attn_backend=be)).loss(
            params, {"tokens": tokens})[1] for be in ("auto", "naive", "jnp")]
        runs = {"loss": losses, **{part: [float(m[part]) for m in parts]
                                   for part in ("ce", "aux")}}
        if cfg.dtype == "bfloat16":
            held["losses"] = runs
        else:
            for part, three in runs.items():
                held[part] = hold_loss(f"scoring {label} {part}", three,
                                       floor=floor / 10)
    else:
        held["loss"] = hold_loss(f"scoring {label} loss", losses,
                                 floor=floor / 10)
    walls = []
    for _ in range(3):                                # warm; host clock, synced
        t0 = time.perf_counter()
        build_model(cfg).loss(params, {"tokens": tokens})
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    earlier = EARLIER_MS.get(f"scoring {label}")
    log(f"[scoring {label}] warm forward + loss, median of 3: "
        f"{np.median(walls):.1f} ms ({walls}"
        + (f"; earlier: {earlier} ms)" if earlier else ")"))
    torch.cuda.empty_cache()
    return dict(launches=launches, ms=wall * 1e3, warm_ms=float(np.median(walls)),
                warm_ms_all=walls, **held)


def zero_paged_counts():
    from repro_torch.kernels.lut_exp import lut_exp
    from repro_torch.kernels.paged_attention import paged_attention
    paged_attention.launches = 0
    paged_attention.combine_launches = 0
    lut_exp.launches = 0


def read_paged_counts():
    from repro_torch.kernels.lut_exp import lut_exp
    from repro_torch.kernels.paged_attention import paged_attention
    return dict(paged_attention=paged_attention.launches,
                paged_combine=paged_attention.combine_launches,
                lut_exp=lut_exp.launches)


def set_paged_counts(counts):
    from repro_torch.kernels.lut_exp import lut_exp
    from repro_torch.kernels.paged_attention import paged_attention
    paged_attention.launches = counts["paged_attention"]
    paged_attention.combine_launches = counts["paged_combine"]
    lut_exp.launches = counts["lut_exp"]


def submit_all(eng, prompts, uid0=0):
    from repro_torch.serving import Request
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=uid0 + i, prompt=p, max_new=MAX_NEW))
    return list(range(uid0, uid0 + len(prompts)))


def timed_pass(eng, cfg, prompts, uid0, tag):
    """Serve the requests once; counts zeroed just before the pass and read
    just after → facts of the pass (streams in request order)."""
    import torch
    uids = submit_all(eng, prompts, uid0)
    eng.finished.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_paged_counts()
    step_ms, kinds, model_steps, configs = [], [], 0, []
    t0 = time.perf_counter()
    while eng.scheduler.has_work():
        s0 = time.perf_counter()
        out = eng.step()
        step_ms.append((time.perf_counter() - s0) * 1e3)
        kinds.append((out.prefill_tokens, out.decode_tokens, out.lanes))
        model_steps += out.lanes > 0
        if out.lanes and out.kernel_config not in configs:
            configs.append(out.kernel_config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_paged_counts()
    peak = torch.cuda.max_memory_allocated()
    done = {r.uid: r.tokens for r in eng.finished}
    if sorted(done) != uids or any(len(done[u]) != MAX_NEW for u in uids):
        fail(f"engine {tag}: not every request produced {MAX_NEW} tokens")
    if any(not 0 <= t < cfg.vocab_size for u in uids for t in done[u]):
        fail(f"engine {tag}: token outside the vocab")
    for kernel in ("paged_attention", "paged_combine"):
        if launches[kernel] != cfg.num_layers * model_steps:
            fail(f"engine {tag}: {kernel} launched {launches[kernel]} times, "
                 f"expected layers × steps = {cfg.num_layers} × {model_steps}")
    if eng.pages_in_use != 0 or eng.kv.free_pages != eng.kv.num_pages:
        fail(f"engine {tag}: {eng.pages_in_use} pages leaked")
    if configs != [eng.kernel_config.describe()]:
        fail(f"engine {tag}: steps recorded kernel configs {configs}, the "
             f"engine's is {eng.kernel_config.describe()}")
    gen = sum(len(done[u]) for u in uids)
    prompt_toks = sum(len(p) for p in prompts)
    return dict(steps=model_steps, launches=launches, generated=gen,
                prompt_tokens=prompt_toks, wall_s=wall, tok_s=gen / wall,
                all_tok_s=(gen + prompt_toks) / wall,
                step_ms_p50=float(np.percentile(step_ms, 50)),
                step_ms_p99=float(np.percentile(step_ms, 99)),
                decode_step_ms_p50=float(np.median(
                    [t for t, (pf, dc, n) in zip(step_ms, kinds)
                     if not pf and dc == n == ENGINE["lanes"]])),
                peak_gib=peak / 2 ** 30, kinds=kinds,
                kernel_config=configs[0], streams=[done[u] for u in uids])


def phase_engine(cfg, params, kv_quant: bool, prompts):
    """The eager arm: serve the requests with ``capture=False`` (the step
    dispatched op by op); → (engine, facts of the run)."""
    from repro_torch.serving import EngineCore
    c = cfg.replace(kv_quant=kv_quant)
    eng = EngineCore(c, params, device=DEV, capture=False, **ENGINE)
    tag = "int8" if kv_quant else "bf16"
    if eng.kernel_config.source != "tuned":
        fail(f"engine {tag}: resolved {eng.kernel_config.describe()}, not "
             f"the tuner table's {MODEL}::cuda row")
    facts = dict(pool=tag, **timed_pass(eng, c, prompts, 0, f"eager {tag}"))
    log(f"[engine {tag}] eager: {facts['steps']} steps, {facts['generated']} "
        f"tokens generated, {facts['prompt_tokens']} prompt tokens in "
        f"{facts['wall_s']:.2f} s → {facts['tok_s']:.1f} generated tok/s "
        f"({facts['all_tok_s']:.1f} incl. prompt); step ms p50 "
        f"{facts['step_ms_p50']:.2f} (earlier: "
        f"{EARLIER_MS[f'step p50 {tag}']}) p99 {facts['step_ms_p99']:.2f}; "
        f"peak {facts['peak_gib']:.2f} GiB; launches {facts['launches']}; "
        f"StepOutput.kernel_config {facts['kernel_config']}")
    return eng, facts


def step_logits(eng, batch):
    """The live lanes' (lanes, V) f32 logits of ``batch`` through ``eng``'s
    pool, eagerly, after the engine ran it (the step rewrites its own KV
    rows with the same values, so it reads the history the step read)."""
    import torch
    from repro_torch.models.lm import lm_step_ragged
    a = {k: torch.from_numpy(v).to(DEV)
         for k, v in eng.step_arrays(batch).items()}
    lg = lm_step_ragged(eng.cfg, eng.params, a["tokens"], eng.kv.pool,
                        a["table"], a["pos"], a["last_idx"], a["cu"],
                        eng.kernel_config, tp_axis=eng.tp_axis)
    return lg[:len(batch.plans)].cpu().numpy()


def spy_batches(eng, seen):
    """Record each step's batch in ``seen[eng]``, and in ``seen[eng,
    "sampled"]`` whether the step runs the sampler (read before the step
    moves the cursors)."""
    inner = eng.scheduler.batch_for

    def spy(wants):
        batch, pre = inner(wants)
        seen[eng] = batch
        seen[eng, "sampled"] = eng._sampling_inputs(batch.plans) is not None
        return batch, pre
    eng.scheduler.batch_for = spy


def lockstep_pass(ce, twin, prompts, tag, windows):
    """The captured engine and an eager twin serve the same greedy requests
    step by step: equal plans, equal picks, and every step's live logits of
    the replayed graph (``graphs.logits``) equal to the logits of the twin's
    eager step, bit for bit (both run the same port code).  ``windows``
    {step index: logdir} arms the twin's profiler on those steps (the eager
    arm's trace) → traces."""
    from repro_torch.serving.sampling import greedy_rows
    seen, traces = {}, {}
    eager_step = twin._step

    def logged_step(*a, greedy=False, sampling=None, **kw):
        # the eager step as the engine runs it (greedy picks of its logits),
        # its logits kept
        if sampling is not None:
            fail(f"compiled {tag}: the lockstep pass serves greedy requests "
                 f"only, and a step sampled")
        seen["logits"] = eager_step(*a, **kw)
        return greedy_rows(seen["logits"])
    twin._step = logged_step
    for eng in (ce, twin):
        spy_batches(eng, seen)
        submit_all(eng, prompts, uid0=100)
        eng.finished.clear()
    i = 0
    while ce.scheduler.has_work() or twin.scheduler.has_work():
        if i in windows:
            twin.obs.arm_profiler(1, windows[i])
        oc, oe = ce.step(), twin.step()
        bc, be = seen[ce], seen[twin]
        plan = [(p.run.req.uid, p.q_len) for p in be.plans]
        if plan != [(p.run.req.uid, p.q_len) for p in bc.plans]:
            fail(f"compiled {tag}: step {i} planned differently from the eager "
                 f"twin")
        diff = [u for u in oe.tokens if oc.tokens.get(u) != oe.tokens[u]]
        if oe.lanes:
            lc = ce.graphs.logits[:len(be.plans)].cpu().numpy()
            le = seen.pop("logits")[:len(be.plans)].cpu().numpy()
            if diff or not np.array_equal(lc.view(np.int32), le.view(np.int32)):
                fail(f"compiled {tag}: step {i}: the replayed graph's logits "
                     f"differ from the eager twin's (max|Δ| "
                     f"{float(np.abs(lc - le).max())}; picks differ for "
                     f"{diff})")
        if i in windows:
            traces[i] = twin.obs.last_trace
        i += 1
    for eng in (ce, twin):
        del eng.scheduler.batch_for                 # the spy
    twin._step = eager_step
    return traces


def step_kind_indices(kinds):
    """Step indices of the pass's first mixed step and first step in which
    every lane decodes and none prefills."""
    mixed = next(i for i, (pf, dc, _) in enumerate(kinds) if pf and dc)
    decode = next(i for i, (pf, dc, n) in enumerate(kinds)
                  if not pf and dc == n == ENGINE["lanes"])
    return {"mixed": mixed, "decode": decode}


KERNEL_GROUPS = (("paged_attention_kernel", "paged split pass"),
                 ("paged_combine", "paged combine"),
                 ("lut_exp_bwd_kernel", "#1 backward"),
                 ("lut_exp_kernel", "#1 lut_exp"),
                 ("dkdv_kernel", "#3 backward"), ("dq_kernel", "#3 backward"),
                 ("delta_kernel", "#3 backward"),
                 ("attention_kernel", "#3 forward"),
                 ("gemm", "GEMM"), ("gemv", "GEMM"), ("xmma", "GEMM"),
                 ("nvjet", "GEMM"),
                 ("cutlass", "GEMM"), ("Memcpy", "copy"), ("Memset", "copy"),
                 ("index", "index / gather / scatter"),
                 ("scatter", "index / gather / scatter"),
                 ("gather", "index / gather / scatter"),
                 ("reduce", "reduce"), ("elementwise", "elementwise"),
                 ("vectorized", "elementwise"))


def kernel_group(name):
    low = name.lower()
    for key, group in KERNEL_GROUPS:
        if key.lower() in low:
            return group
    return "other"


def read_window(path, label):
    """Summarise a profiler window's trace (``profile_summary``), print it,
    and keep the trace gzipped beside it; fails when the window wrote no
    trace."""
    import gzip
    import os
    from repro_torch.serving.tracing import profile_summary
    if path is None or not os.path.exists(path):
        fail(f"profiler window {label} wrote no trace")
    s = profile_summary(path, top=None)
    groups = {}
    for name, ms in s["by_name"].items():
        g = kernel_group(name)
        groups[g] = groups.get(g, 0.0) + ms
    top = dict(list(s["by_name"].items())[:8])
    with open(path, "rb") as f_in, gzip.open(path + ".gz", "wb") as f_out:
        f_out.write(f_in.read())
    os.remove(path)
    out = dict(launches=s["launches"], device_ms=s["device_ms"],
               window_ms=s["window_ms"], busy_ms=s["busy_ms"],
               idle_share=s["idle_share"],
               kernel_span_ms=s["kernel_span_ms"],
               kernel_span_idle_share=s["kernel_span_idle_share"],
               host_launch_calls=s["host_launch_calls"],
               launch_call_ms=s["launch_call_ms"],
               by_group=dict(sorted(groups.items(), key=lambda kv: -kv[1])),
               top=top, trace=os.path.relpath(path + ".gz", ROOT))
    log(f"[profile {label}] {s['launches']} kernels on the device, "
        f"{s['device_ms']:.3f} ms device time in a {s['window_ms']:.3f} ms "
        f"window: idle share {s['idle_share']:.3f}, "
        f"{s['kernel_span_idle_share']:.3f} between the first and the last "
        f"kernel ({s['kernel_span_ms']:.3f} ms apart); host launch calls "
        f"{s['host_launch_calls']}, {s['launch_call_ms']:.3f} ms of host "
        f"time; by group (ms) "
        + json.dumps({k: round(v, 4) for k, v in out["by_group"].items()})
        + "; top kernels (ms) "
        + json.dumps({k[:60]: round(v, 4) for k, v in top.items()})
        + f"; trace {out['trace']}")
    if not s["launches"]:
        log(f"[profile {label}] the trace holds no device event: device "
            f"times, launches and idle share of this window not measured")
    return out


def phase_compiled(cfg, params, kv_quant: bool, prompts, eager):
    """The captured arm: one engine with ``capture=True`` (one CUDA graph per
    (T, P), replayed) serves the same requests.

    Pass 1 runs in lockstep with a fresh eager twin (``lockstep_pass``),
    whose profiler takes the eager arm's windows; warm passes repeat until
    one captures nothing new (at most ``WARM_PASSES``, pass 1 included);
    then ``obs.mark_warm()`` and a measured pass (``timed_pass``: launches equal
    layers × model steps on replayed steps); then a pass with the replayed
    arm's profiler windows.  Every pass's greedy streams must equal the
    eager arm's."""
    import torch
    from repro_torch.serving import EngineCore
    c = cfg.replace(kv_quant=kv_quant)
    tag = "int8" if kv_quant else "bf16"
    kinds = step_kind_indices(eager["kinds"])
    ce = EngineCore(c, params, device=DEV, **ENGINE)
    twin = EngineCore(c, params, device=DEV, capture=False, **ENGINE)
    tdir = ROOT / "chiprun_out" / "traces"
    traces = lockstep_pass(
        ce, twin, prompts, tag,
        {i: str(tdir / f"{tag}_eager_{k}") for k, i in kinds.items()})
    windows = {f"eager {k}": read_window(traces[i], f"{tag} eager {k} step {i}")
               for k, i in kinds.items()}
    del twin
    torch.cuda.empty_cache()

    def check_streams(streams, label):
        for j, (got, want) in enumerate(zip(streams, eager["streams"])):
            if got != want:
                fail(f"compiled {tag} {label}: request {j}'s greedy stream "
                     f"differs from the eager arm's")

    check_streams([r.tokens for r in sorted(ce.finished, key=lambda r: r.uid)],
                  "pass 1")
    captures = [ce.graphs.captures]
    ms_at = [len(ce.graphs.capture_ms)]
    uid0 = 200
    while captures[-1] and len(captures) < WARM_PASSES:
        before = ce.graphs.captures
        f = timed_pass(ce, c, prompts, uid0, f"compiled {tag} warm")
        check_streams(f["streams"], f"warm pass {len(captures) + 1}")
        captures.append(ce.graphs.captures - before)
        ms_at.append(len(ce.graphs.capture_ms))
        uid0 += 100
    cap_ms = ce.graphs.capture_ms
    per_pass_ms = [cap_ms[a:b] for a, b in zip([0] + ms_at[:-1], ms_at)]
    ce.obs.mark_warm()
    reg = ce.obs.registry
    win, snap = ce.obs.engine_window(), reg.snapshot()
    measured = timed_pass(ce, c, prompts, uid0, f"compiled {tag}")
    check_streams(measured["streams"], "measured pass")
    lat = ce.obs.engine_latency_summary(win)
    delta = reg.delta(snap)
    retraces = int(reg.value("step_retraces_total"))
    uid0 += 100
    submit_all(ce, prompts, uid0)                    # the replayed windows
    ce.finished.clear()
    at = {i: k for k, i in kinds.items()}
    i = 0
    while ce.scheduler.has_work():
        if i in at:
            ce.obs.arm_profiler(1, str(tdir / f"{tag}_replayed_{at[i]}"))
        ce.step()
        if i in at:
            windows[f"replayed {at[i]}"] = read_window(
                ce.obs.last_trace, f"{tag} replayed {at[i]} step {i}")
        i += 1
    check_streams([r.tokens for r in sorted(ce.finished, key=lambda r: r.uid)],
                  "profiled pass")
    if ce.obs.registry.value("step_retraces_total") != retraces:
        fail(f"compiled {tag}: the profiled pass captured again")
    facts = dict(
        pool=tag, captures_per_pass=captures,
        capture_ms=[float(np.median(m)) if m else 0.0 for m in per_pass_ms],
        capture_ms_all=cap_ms, keys=sorted(ce.graphs.keys),
        step_retraces_total=retraces,
        step_traces_total=int(reg.value("step_traces_total")),
        ttft_ms_p50=lat["ttft_ms_p50"],
        ttft_ms_p99=lat["ttft_ms_p99"], tpot_ms=lat["tpot_ms"],
        registry_delta={k: v for k, v in delta.items() if v},
        windows=windows, step_kinds=kinds, streams=measured["streams"],
        **{k: v for k, v in measured.items() if k not in ("streams", "kinds")})
    log(f"[compiled {tag}] captures per pass {captures} (pass 1 in lockstep "
        f"with the eager twin), median ms per capture "
        f"{[round(m, 1) for m in facts['capture_ms']]}; keys (T, P) "
        f"{facts['keys']}; after mark_warm(): step_retraces_total {retraces}; "
        f"measured pass: {measured['steps']} steps, step ms p50 "
        f"{measured['step_ms_p50']:.2f} p99 {measured['step_ms_p99']:.2f} "
        f"(eager {eager['step_ms_p50']:.2f} / {eager['step_ms_p99']:.2f}); "
        f"{measured['tok_s']:.1f} generated tok/s ({measured['all_tok_s']:.1f} "
        f"incl. prompt; eager {eager['tok_s']:.1f}); peak "
        f"{measured['peak_gib']:.2f} GiB (eager {eager['peak_gib']:.2f}); "
        f"TTFT p50 {lat['ttft_ms_p50']:.1f} p99 {lat['ttft_ms_p99']:.1f} ms, "
        f"TPOT {lat['tpot_ms']:.2f} ms (registry); launches "
        f"{measured['launches']} = layers × steps; StepOutput.kernel_config "
        f"{measured['kernel_config']}; greedy streams equal the "
        f"eager arm's on all {len(prompts)} requests, logits bit for bit on "
        f"every step of the lockstep")
    del ce
    torch.cuda.empty_cache()
    return facts


def phase_config_arms(cfg, params, prompts):
    """Phase 7's bf16 traffic through two captured engines side by side:
    one on the committed tuned row, one at ``DEFAULT_CONFIG``.  Each warms
    until a pass captures nothing new (at most ``WARM_PASSES``); then their
    measured passes interleave (tuned, default, tuned, default).  Each arm
    repeats its own streams; the default arm's equal the tuned arm's by the
    margin rule (``hold_by_margin``: another block_q or pages per split
    rounds the attention apart, so near-ties may fork).  → both arms' step
    p50s, tokens/s and forks."""
    import torch
    from repro_torch.kernels.autotune import DEFAULT_CONFIG, resolve_config
    from repro_torch.serving import EngineCore
    configs = {"tuned": resolve_config(cfg.name, "cuda"),
               "default": DEFAULT_CONFIG}
    make = {k: (lambda kc=kc: EngineCore(cfg, params, device=DEV,
                                         kernel_config=kc, **ENGINE))
            for k, kc in configs.items()}
    wave = lambda uid0: [[(uid0 + i, p) for i, p in enumerate(prompts)]]  # noqa: E731
    engs = {k: m() for k, m in make.items()}
    warm, runs, uid0 = {}, {k: [] for k in engs}, 0
    for k, eng in engs.items():
        caps = []
        while len(caps) < WARM_PASSES and (not caps or caps[-1]):
            before = eng.graphs.captures
            serve_waves(eng, wave(uid0))
            caps.append(eng.graphs.captures - before)
            uid0 += 100
        warm[k] = caps
    for _ in range(2):
        for k, eng in engs.items():
            r = serve_waves(eng, wave(uid0))
            r["streams"] = {u - uid0: t for u, t in r["streams"].items()}
            runs[k].append(r)
            uid0 += 100
    for k, rs in runs.items():
        if rs[0]["streams"] != rs[1]["streams"]:
            fail(f"config arm {k}: two passes served different streams")
    streams = {k: rs[0]["streams"] for k, rs in runs.items()}
    del engs
    torch.cuda.empty_cache()
    serve = lambda eng, t: serve_waves(eng, wave(0), targets=t)  # noqa: E731
    forks = hold_by_margin("config arms", streams["default"],
                           streams["tuned"],
                           fresh_run(make["default"], serve),
                           fresh_run(make["tuned"], serve))
    facts = {k: dict(config=configs[k].describe(), warm_captures=warm[k],
                     step_ms_p50=[r["step_ms_p50"] for r in rs],
                     step_ms_p99=[r["step_ms_p99"] for r in rs],
                     tok_s=[r["tok_s"] for r in rs], steps=rs[0]["steps"],
                     launches=rs[0]["launches"])
             for k, rs in runs.items()}
    facts["forks"] = forks
    t, d = facts["tuned"], facts["default"]
    log(f"[config arms bf16] tuned {t['config']}: step ms p50 "
        f"{[round(x, 2) for x in t['step_ms_p50']]}, tok/s "
        f"{[round(x, 1) for x in t['tok_s']]}; DEFAULT_CONFIG: step ms p50 "
        f"{[round(x, 2) for x in d['step_ms_p50']]}, tok/s "
        f"{[round(x, 1) for x in d['tok_s']]} (passes interleaved; warm "
        f"captures {warm}; {CARD[0]}); streams equal"
        + (f" save near-tie forks {forks}" if forks else ""))
    return facts


def write_checkpoint(ckpt_dir, step, cfg, params):
    """Write ``{"params": params}`` in the reference store's layout
    (``src/repro/checkpoint/store.py::save``): ``step_<8 digits>/``
    holding ``arrays.npz`` (leaf path → array; bf16 leaves as raw 2-byte
    values, as ``np.savez`` stores an ml_dtypes bf16 array) and
    ``manifest.json`` (shape, dtype and sha256 per leaf).  A fixture: the
    package reads checkpoints and does not write them."""
    import hashlib
    import os
    import torch
    from repro_torch.params import to_flat
    flat, dtypes = {}, {}
    for path, t in to_flat(params, cfg).items():
        t = t.detach().contiguous().cpu()
        name = "params/" + path
        if t.dtype == torch.bfloat16:
            flat[name] = t.view(torch.int16).numpy().view("V2")
            dtypes[name] = "bfloat16"
        else:
            flat[name] = t.numpy()
            dtypes[name] = str(flat[name].dtype)
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    os.makedirs(d, exist_ok=True)
    np.savez(os.path.join(d, "arrays.npz"), **flat)
    manifest = {"step": step, "extra": {},
                "leaves": {k: {"shape": list(v.shape), "dtype": dtypes[k],
                               "sha256": hashlib.sha256(
                                   np.ascontiguousarray(v).tobytes())
                               .hexdigest()[:16]}
                           for k, v in flat.items()}}
    with open(os.path.join(d, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return d


def phase_checkpoint(cfg, params, prompts):
    """The checkpoint read path at ``CKPT_LAYERS`` layers of the model's
    full width (phase 7e): the seeded parameters written by the fixture
    (``write_checkpoint``), restored through ``checkpoint.restore_params``
    onto the card (every leaf bit for bit, bf16 kept), then one engine
    step on each set of parameters over phase 7's prompts: equal picks
    and the step's logits equal bit for bit; a leaf that no longer matches
    its manifest raises ``IOError``."""
    import os
    import shutil
    import torch
    from repro_torch.checkpoint import latest_step, restore_params
    from repro_torch.models.lm import layer_keys
    from repro_torch.serving import EngineCore, Request
    c = cfg.replace(num_layers=CKPT_LAYERS)
    keys = set(layer_keys(cfg))
    mem = {k: (v[:CKPT_LAYERS].contiguous() if k in keys else v)
           for k, v in params.items()}
    root = ROOT / "build" / "ckpt_roundtrip"
    shutil.rmtree(root, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        d = write_checkpoint(str(root), 7, c, mem)
        write_s = time.perf_counter() - t0
        nbytes = os.path.getsize(os.path.join(d, "arrays.npz"))
        t0 = time.perf_counter()
        restored, step, _ = restore_params(str(root), c, DEV)
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        if step != 7 or latest_step(str(root)) != 7:
            fail(f"checkpoint: restored step {step}, not 7")
        for k, v in mem.items():
            r = restored[k]
            if r.dtype != v.dtype or r.shape != v.shape or r.device != v.device \
                    or not torch.equal(r.view(torch.int16) if r.dtype ==
                                       torch.bfloat16 else r,
                                       v.view(torch.int16) if v.dtype ==
                                       torch.bfloat16 else v):
                fail(f"checkpoint: leaf {k} did not come back bit for bit")
        picks, logits = [], []
        for p in (mem, restored):
            eng = EngineCore(c, p, device=DEV, capture=False, **ENGINE)
            seen = {}
            spy_batches(eng, seen)
            for i, prompt in enumerate(prompts):
                eng.submit(Request(uid=i, prompt=prompt, max_new=MAX_NEW))
            out = eng.step()
            picks.append(out.tokens)
            logits.append(step_logits(eng, seen[eng]))
            del eng
        if picks[0] != picks[1] or not np.array_equal(logits[0], logits[1]):
            fail("checkpoint: the restored parameters' step differs from the "
                 "parameters in memory")
        manifest = os.path.join(d, "manifest.json")
        with open(manifest) as f:
            m = json.load(f)
        leaf = sorted(m["leaves"])[0]
        m["leaves"][leaf]["sha256"] = "0" * 16
        with open(manifest, "w") as f:
            json.dump(m, f)
        try:
            restore_params(str(root), c, DEV)
        except IOError as e:
            caught = str(e)
        else:
            fail(f"checkpoint: a leaf that does not match its manifest "
                 f"({leaf}) restored without an IOError")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del restored
    torch.cuda.empty_cache()
    facts = dict(layers=CKPT_LAYERS, bytes=nbytes, leaves=len(mem),
                 write_s=write_s, restore_s=read_s,
                 logits_shape=list(logits[0].shape), corrupt_leaf=leaf,
                 error=caught)
    log(f"[checkpoint] {len(mem)} leaves, {nbytes / 1e9:.2f} GB at "
        f"{CKPT_LAYERS} layers of {cfg.name}'s width: written by the fixture "
        f"in {write_s:.1f} s, restored onto the card in {read_s:.1f} s, every "
        f"leaf bit for bit; one engine step's logits {tuple(logits[0].shape)} "
        f"equal bit for bit, picks equal; a stale manifest entry for {leaf} "
        f"raises IOError ({caught}); {CARD[0]}")
    return facts


# --------------------------------------------- prefix cache, speculation --

class ScriptedProposer:
    """Drafts by replaying known greedy continuations (the design of
    ``tests/test_spec_decode.py``'s proposer): ``truth`` maps each prompt
    to its stream; ``corrupt(i, n)`` names the position of the i-th
    proposal (of n drafts) to put off by one, or None."""

    def __init__(self, truth, vocab, corrupt):
        self.truth = {tuple(int(t) for t in p): list(s)
                      for p, s in truth.items()}
        self.vocab = vocab
        self.corrupt = corrupt
        self.calls = 0
        self.log = []                         # (drafts, true continuation)

    def __call__(self, stream, k):
        s = [int(t) for t in stream]
        for prompt, toks in self.truth.items():
            lp = len(prompt)
            if tuple(s[:lp]) == prompt and s[lp:] == toks[:len(s) - lp]:
                cont = toks[len(s) - lp:len(s) - lp + k]
                drafts = list(cont)
                m = self.corrupt(self.calls, len(drafts))
                if m is not None and m < len(drafts):
                    drafts[m] = (drafts[m] + 1) % self.vocab
                self.calls += 1
                if drafts:
                    self.log.append((drafts, cont))
                return drafts
        return []


def acceptance_kinds(log):
    """How each logged proposal fared: every draft accepted, none, or a
    proper prefix."""
    kinds = {"full": 0, "none": 0, "partial": 0}
    for drafts, cont in log:
        n = len(drafts)
        acc = next((j for j in range(n) if drafts[j] != cont[j]), n)
        kinds["full" if acc == n else "none" if acc == 0 else "partial"] += 1
    return kinds


def serve_waves(eng, waves, targets=frozenset(), profile_at=None):
    """Serve ``waves`` (lists of (uid, prompt) or (uid, prompt, sampling
    params)), each submitted once the
    engine drained the one before; kernel counts zeroed just before and
    read just after → facts of the run and of each wave, and the logits
    row of every (uid, token index) in ``targets`` (the eager step re-run
    on the engine's pool right after the step that committed the token;
    its launches are not counted).  ``profile_at`` {step index: logdir}
    arms the engine's profiler on those steps and reads each window."""
    import torch
    from repro_torch.serving import Request
    seen, reqs, logits, keys = {}, {}, {}, set()
    step_log, windows, profile_at = [], {}, profile_at or {}
    spy_batches(eng, seen)
    eng.finished.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_paged_counts()
    t0 = time.perf_counter()
    per_wave = []
    for wave in waves:
        w = dict(step_ms=[], steps=0, prefill_tokens=0, hit_tokens=0,
                 drafted=0, accepted=0, ttft_ms={},
                 captures=eng.trace_count)
        t_sub = time.perf_counter()
        for uid, prompt, *sp in wave:
            reqs[uid] = Request(uid=uid, prompt=prompt, max_new=MAX_NEW,
                                sampling=sp[0] if sp else None)
            eng.submit(reqs[uid])
        while eng.scheduler.has_work():
            before = {u: len(r.tokens) for u, r in reqs.items()}
            n0, c0 = read_paged_counts()["paged_attention"], eng.trace_count
            if len(step_log) in profile_at:
                eng.obs.arm_profiler(1, profile_at[len(step_log)])
            s0 = time.perf_counter()
            out = eng.step()
            now = time.perf_counter()
            if len(step_log) in profile_at:
                windows[len(step_log)] = read_window(
                    eng.obs.last_trace, f"step {len(step_log)}")
            step_log.append(dict(
                prefill=out.prefill_tokens, decode=out.decode_tokens,
                lanes=out.lanes, drafted=out.drafted_tokens,
                preempted=len(out.preempted),
                sampled=bool(out.lanes) and seen[eng, "sampled"],
                width=out.padded_rows, ms=(now - s0) * 1e3,
                captures=eng.trace_count - c0,
                launches=read_paged_counts()["paged_attention"] - n0))
            if out.lanes and out.kernel_config != eng.kernel_config.describe():
                fail(f"a step recorded kernel config {out.kernel_config}, "
                     f"the engine's is {eng.kernel_config.describe()}")
            w["step_ms"].append((now - s0) * 1e3)
            w["steps"] += out.lanes > 0
            w["prefill_tokens"] += out.prefill_tokens
            w["hit_tokens"] += out.prefix_hit_tokens
            w["drafted"] += out.drafted_tokens
            w["accepted"] += out.accepted_tokens
            if out.lanes:
                keys.add(seen[eng].table.shape)
            for u in out.tokens:
                w["ttft_ms"].setdefault(u, (now - t_sub) * 1e3)
            lg = None
            for i, plan in enumerate(seen[eng].plans if out.lanes else ()):
                u = plan.run.req.uid
                for j in range(before[u], len(reqs[u].tokens)):
                    if (u, j) in targets:
                        if lg is None:          # not the engine's launches
                            counts = read_paged_counts()
                            lg = step_logits(eng, seen[eng])
                            set_paged_counts(counts)
                        logits[u, j] = (lg[i] if lg.ndim == 2
                                        else lg[i, j - before[u]])
        w["wall_s"] = time.perf_counter() - t_sub
        w["captures"] = eng.trace_count - w["captures"]
        w["generated"] = sum(len(reqs[u].tokens) for u, *_ in wave)
        per_wave.append(w)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_paged_counts()
    del eng.scheduler.batch_for                     # the spy
    streams = {u: list(r.tokens) for u, r in reqs.items()}
    steps = sum(w["steps"] for w in per_wave)
    step_ms = [t for w in per_wave for t in w["step_ms"]]
    gen = sum(len(t) for t in streams.values())
    if any(len(t) != MAX_NEW or not all(0 <= x < eng.cfg.vocab_size for x in t)
           for t in streams.values()):
        fail("a request did not produce MAX_NEW in-vocab tokens")
    for kernel in ("paged_attention", "paged_combine"):
        if launches[kernel] != eng.cfg.num_layers * steps:
            odd = [(i, st) for i, st in enumerate(step_log) if st["launches"]
                   != eng.cfg.num_layers * (st["lanes"] > 0)]
            fail(f"{kernel} launched {launches[kernel]} times, expected "
                 f"layers × steps = {eng.cfg.num_layers} × {steps}; steps off "
                 f"the rule: {odd}")
    return dict(streams=streams, logits=logits, waves=per_wave, steps=steps,
                keys=sorted(keys), step_log=step_log, windows=windows,
                launches=launches, wall_s=wall, generated=gen,
                tok_s=gen / wall, step_ms_p50=float(np.percentile(step_ms, 50)),
                step_ms_p99=float(np.percentile(step_ms, 99)),
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)


def fresh_run(make_eng, serve):
    """→ a function of targets that serves them on a fresh engine
    (``serve(eng, targets)``) and frees it: one arm run again."""
    def run(targets):
        import torch
        eng = make_eng()
        try:
            return serve(eng, targets)
        finally:
            del eng
            torch.cuda.empty_cache()
    return run


def sampled_fork(label, u, j, rows, toks, sp):
    """Hold a fork of sampled request ``u`` at its token ``j`` (arms "got"
    and "want": their logits rows and tokens) to the logits gap between the
    arms.  The draw, re-run on each arm's row with the request's own key
    ``fold_in(PRNGKey(seed), j)``, must give that arm's token: key, counter
    and params agree, only the logits part the arms.  With x = (logits −
    max) / t, a logits gap moves every difference of x by at most
    ``shift`` = 4·gap / t.  So where "got" kept "want"'s token, "want"'s
    lead (x + g)[want] − (x + g)[got] must be at most ``shift``; and a
    token kept by one arm and masked by the other must lie within it of
    the masking arm's boundary: below the k-th largest x by at most
    ``shift``, or a mass before it below p·e^shift.  The launches of the
    check are the caller's to put back.  → (lead, shift)."""
    import math
    import torch
    from repro_torch.core import prng
    from repro_torch.core.lut_softmax import lut_softmax
    from repro_torch.kernels.lut_exp import lut_exp
    from repro_torch.serving.sampling import (_masked_scores, _request_keys,
                                              sample_rows)
    one = lambda v, dt: torch.tensor([v], dtype=dt, device=DEV)  # noqa: E731
    t, k = sp.temperature, sp.top_k or 0
    p = 1.0 if sp.top_p is None else sp.top_p
    params = dict(temperature=one(t, torch.float32),
                  top_k=one(k, torch.int32), top_p=one(p, torch.float32),
                  seed=one(sp.seed or 0, torch.int64),
                  counter=one(j, torch.int64))
    arm = {}
    for side in ("got", "want"):
        lg = torch.as_tensor(rows[side], device=DEV,
                             dtype=torch.float32)[None]
        if int(sample_rows(lg, **params)[0]) != toks[side]:
            fail(f"{label}: request {u}'s draw at token {j} on the {side} "
                 f"arm's logits is not its token {toks[side]}")
        x, keep = _masked_scores(lg, params["temperature"], params["top_k"],
                                 params["top_p"], lut_exp)
        order = torch.argsort(-x, dim=-1, stable=True)
        probs = lut_softmax(x, exp=lut_exp).gather(-1, order)
        before = torch.empty_like(probs).scatter_(
            -1, order, torch.cumsum(probs, -1) - probs)
        xu = (lg - lg.amax()) / t
        kth = (float(torch.sort(xu, descending=True).values[0, k - 1])
               if k else -math.inf)
        arm[side] = dict(xu=xu[0].cpu().numpy(), keep=keep[0].cpu().numpy(),
                         before=before[0].cpu().numpy(), kth=kth, lg=lg)
    g = prng.gumbel(*_request_keys(params["seed"], params["counter"]),
                    arm["got"]["lg"].shape[-1])[0].cpu().numpy()
    gap = float((arm["got"]["lg"] - arm["want"]["lg"]).abs().max())
    shift = 4 * gap / t
    for tok in toks.values():
        kept = {side: bool(a["keep"][tok]) for side, a in arm.items()}
        if kept["got"] == kept["want"]:
            continue
        m = arm["got" if not kept["got"] else "want"]
        if k and m["xu"][tok] < m["kth"]:
            near = m["kth"] - m["xu"][tok] <= shift
        else:
            near = m["before"][tok] < p * math.exp(shift)
        if not near:
            fail(f"{label}: request {u}'s token {tok} at {j} is kept by one "
                 f"arm and masked by the other beyond the logits gap {gap}")
    w, o = toks["want"], toks["got"]
    xw = arm["want"]["xu"]
    lead = float((xw[w] + g[w]) - (xw[o] + g[o]))
    if arm["got"]["keep"][w] and not lead <= shift:
        fail(f"{label}: request {u} differs at token {j} with a draw lead "
             f"{lead} above the {shift} a logits gap of {gap} can move")
    return lead, shift


def hold_by_margin(label, got, want, rerun_got, rerun_want, sampling=None):
    """Hold streams ``got`` against ``want`` ({uid: tokens}) by the near-tie
    margin rule: where a request's tokens first differ, both arms are run
    again (they are deterministic: the rerun must repeat the stream) and
    the logits row of that token read from each; the fork stands only if
    ``want``'s top-2 margin there lies below the largest logit gap between
    the two rows.  A sampled request ({uid: params} in ``sampling``) is
    held by ``sampled_fork`` instead.  The fork check's launches are put
    back out of the counts.  → the forks, each with its margin and gap."""
    forks = {}
    for u, w in want.items():
        j = next((i for i, (a, b) in enumerate(zip(got[u], w)) if a != b),
                 None)
        if j is not None:
            forks[u] = j
    if not forks:
        return []
    targets = frozenset(forks.items())
    out = []
    lg, lw = rerun_got(targets), rerun_want(targets)
    for (rerun, ref, side) in ((lg, got, "got"), (lw, want, "want")):
        if {u: rerun["streams"][u] for u in ref} != ref:
            fail(f"{label}: the {side} arm's rerun served other streams")
    counts = read_paged_counts()
    for u, j in sorted(forks.items()):
        a, b = lg["logits"][u, j], lw["logits"][u, j]
        sp = (sampling or {}).get(u)
        if sp is not None and not sp.greedy:
            lead, shift = sampled_fork(
                label, u, j, dict(got=a, want=b),
                dict(got=got[u][j], want=want[u][j]), sp)
            fork = dict(uid=u, token=j, lead=lead, shift=shift)
        else:
            top2 = np.sort(b)[-2:]
            margin = float(top2[1] - top2[0])
            gap = float(np.abs(a - b).max())
            fork = dict(uid=u, token=j, margin=margin, gap=gap)
            if not margin < gap:
                fail(f"{label}: request {u} differs at token {j} with a top-2 "
                     f"margin {margin} not below the logit gap {gap}")
        log(f"[{label}] request {u} forks at token {j}: {fork}")
        out.append(fork)
    set_paged_counts(counts)
    return out


def prefix_traffic(cfg, seed=19, uid0=0):
    """8 requests: one 520-token system prompt, each with its own tail of
    32·(i + 1) tokens; waves: request 0 alone, then 1–7 together, then all
    8 again (uids + 8)."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, cfg.vocab_size, PREFIX_SHARED)
    prompts = [np.concatenate([shared, rng.integers(
        0, cfg.vocab_size, PREFIX_TAIL * (i + 1))]).astype(np.int32)
        for i in range(8)]
    return [[(uid0, prompts[0])],
            [(uid0 + i, prompts[i]) for i in range(1, 8)],
            [(uid0 + 8 + i, p) for i, p in enumerate(prompts)]]


def spy_cow(eng, originals):
    """Record every copy-on-write's original page and its bits at the copy
    (a device clone, no sync)."""
    inner = eng.kv.cow

    def cow(page):
        if eng.kv.ref[page] > 1:
            originals.append((page, {k: t[:, page].clone()
                                     for k, t in eng.kv.pool.items()}))
        return inner(page)
    eng.kv.cow = cow


def pools_equal(a, b):
    """Bit-equality of two engines' pools, the scratch page left out (dead
    rows all write there, in no defined order)."""
    import torch
    for name, t in a.kv.pool.items():
        u, v = t[:, :-1], b.kv.pool[name][:, :-1]
        if t.dtype == torch.bfloat16:
            u, v = u.view(torch.int16), v.view(torch.int16)
        elif t.dtype == torch.float32:
            u, v = u.view(torch.int32), v.view(torch.int32)
        if not torch.equal(u, v):
            return False
    return True


def phase_prefix(cfg, params, kv_quant: bool):
    """The prefix cache at full width: ``prefix_traffic`` through a cached
    captured engine (the main path), a cached eager engine and an uncached
    captured engine, each warmed first by the same traffic on another
    system prompt (its (T, P) keys captured, its pages cached apart).
    Request 0 publishes 36 pages; page 32 of its table holds 8 prompt rows
    and 8 of its tail, so requests 1–7 hit 520 tokens with a partial page,
    copied before their first cold row; the re-served wave hits up to
    len − 1.  Gates: captured = eager bit for bit (streams, stats, pools);
    streams = the uncached arm's by the margin rule; every copied original
    keeps its bits; after the drain only cached pages stay in use."""
    import torch
    from repro_torch.serving import EngineCore
    c = cfg.replace(kv_quant=kv_quant)
    tag = "int8" if kv_quant else "bf16"
    waves = prefix_traffic(c)
    warm = prefix_traffic(c, seed=20, uid0=100)
    make = lambda **kw: EngineCore(c, params, device=DEV, **ENGINE, **kw)  # noqa: E731

    def served(eng, targets=frozenset(), originals=None):
        serve_waves(eng, warm)
        before = dict(eng.prefix_stats)
        if originals is not None:
            spy_cow(eng, originals)
        facts = serve_waves(eng, waves, targets)
        if originals is not None:
            del eng.kv.cow                           # the spy
        facts["stats"] = {k: v - before.get(k, 0)
                          for k, v in eng.prefix_stats.items()}
        facts["captures"] = eng.graphs.captures
        if eng.pages_in_use != eng.prefix_stats.get("cached_pages", 0):
            fail(f"prefix {tag}: {eng.pages_in_use} pages in use after the "
                 f"drain, {eng.prefix_stats.get('cached_pages', 0)} cached")
        return facts

    originals = []
    ce = make(prefix_cache=True)
    cf = served(ce, originals=originals)
    ee = make(prefix_cache=True, capture=False)
    ef = served(ee)
    if cf["streams"] != ef["streams"] or ce.prefix_stats != ee.prefix_stats:
        fail(f"prefix {tag}: the captured arm's streams or cache stats differ "
             f"from the eager arm's")
    if not pools_equal(ce, ee):
        fail(f"prefix {tag}: the captured arm's pool bytes differ from the "
             f"eager arm's")
    for page, bits in originals:
        if not ce.prefix_cache.holds(page):
            fail(f"prefix {tag}: copied original page {page} left the cache")
        for k, t in ce.kv.pool.items():
            if not torch.equal(t[:, page], bits[k]):
                fail(f"prefix {tag}: original page {page} ({k}) changed after "
                     f"its copy")
    cow_pages = sorted({p for p, _ in originals})
    cached = ce.prefix_stats["cached_pages"]
    del ce, ee, originals
    torch.cuda.empty_cache()
    eng = make()
    off = served(eng)
    del eng
    torch.cuda.empty_cache()

    forks = hold_by_margin(
        f"prefix {tag}", cf["streams"], off["streams"],
        fresh_run(lambda: make(prefix_cache=True), served),
        fresh_run(make, served))
    stats = cf["stats"]
    w1, w2, w3 = cf["waves"]
    ttft = [w2["ttft_ms"][u] for u in range(1, 8)]
    facts = dict(
        pool=tag, hit_tokens=stats["hit_tokens"],
        hit_tokens_by_wave=[w["hit_tokens"] for w in cf["waves"]],
        partial_hits=stats["partial_hits"], cow_copies=stats["cow_copies"],
        cow_pages=cow_pages, cached_pages=cached,
        prefill_tokens=[w["prefill_tokens"] for w in cf["waves"]],
        prefill_tokens_off=[w["prefill_tokens"] for w in off["waves"]],
        steps=cf["steps"], steps_off=off["steps"],
        steps_by_wave=[w["steps"] for w in cf["waves"]],
        captures=cf["captures"], captures_off=off["captures"],
        captures_by_wave=[w["captures"] for w in cf["waves"]],
        step_ms_p50=cf["step_ms_p50"], step_ms_p99=cf["step_ms_p99"],
        eager_step_ms_p50=ef["step_ms_p50"],
        eager_step_ms_p99=ef["step_ms_p99"],
        off_step_ms_p50=off["step_ms_p50"], off_step_ms_p99=off["step_ms_p99"],
        ttft_ms_1_7=ttft, ttft_ms_1_7_off=[off["waves"][1]["ttft_ms"][u]
                                           for u in range(1, 8)],
        wave_s=[w["wall_s"] for w in cf["waves"]],
        wave_s_off=[w["wall_s"] for w in off["waves"]],
        tok_s=cf["tok_s"], tok_s_off=off["tok_s"],
        launches=cf["launches"], launches_off=off["launches"],
        peak_gib=cf["peak_gib"], peak_gib_off=off["peak_gib"], forks=forks)
    if stats["partial_hits"] < 7 or stats["cow_copies"] < 7:
        fail(f"prefix {tag}: requests 1–7 did not all take a partial hit and "
             f"a copy: {stats}")
    if w2["hit_tokens"] != 7 * PREFIX_SHARED:
        fail(f"prefix {tag}: wave 2 hit {w2['hit_tokens']} tokens, expected "
             f"7 × {PREFIX_SHARED}")
    if w3["hit_tokens"] != sum(len(p) - 1 for _, p in waves[2]):
        fail(f"prefix {tag}: the re-served wave hit {w3['hit_tokens']} "
             f"tokens, not every prompt up to len − 1")
    log(f"[prefix {tag}] cached = eager bit for bit (streams, stats, pools); "
        f"hit tokens by wave {facts['hit_tokens_by_wave']} "
        f"({facts['partial_hits']} partial hits), {facts['cow_copies']} CoW "
        f"copies of pages {cow_pages}, originals unchanged; prefill tokens "
        f"streamed by wave {facts['prefill_tokens']} against "
        f"{facts['prefill_tokens_off']} uncached; steps {cf['steps']} "
        f"{facts['steps_by_wave']} against {off['steps']}; step ms p50 "
        f"{cf['step_ms_p50']:.2f} p99 {cf['step_ms_p99']:.2f} (eager "
        f"{ef['step_ms_p50']:.2f} / {ef['step_ms_p99']:.2f}; uncached "
        f"{off['step_ms_p50']:.2f} / {off['step_ms_p99']:.2f}); captures in "
        f"the measured traffic {sum(facts['captures_by_wave'])}, "
        f"{cf['captures']} with the warm-up's; TTFT of requests 1–7 (ms, "
        f"host clock from their submission) {[round(t, 1) for t in ttft]} "
        f"against {[round(t, 1) for t in facts['ttft_ms_1_7_off']]} uncached; "
        f"waves {[round(t, 3) for t in facts['wave_s']]} s against "
        f"{[round(t, 3) for t in facts['wave_s_off']]}; {cf['tok_s']:.1f} "
        f"generated tok/s against {off['tok_s']:.1f}; #2 launches "
        f"{cf['launches']} ({off['launches']} uncached); peak "
        f"{cf['peak_gib']:.2f} GiB ({off['peak_gib']:.2f}); {cached} pages "
        f"cached after the drain; streams = uncached"
        + (f" save {len(forks)} near-tie forks {forks}" if forks else ""))
    return facts


def phrase_prompts(cfg):
    """8 prompts, each a 32-token phrase of its own repeated 8 times."""
    rng = np.random.default_rng(23)
    return [np.tile(rng.integers(0, cfg.vocab_size, SPEC_PHRASE), 8)
            .astype(np.int32) for _ in range(8)]


def phase_spec(cfg, params, prompts, want, plain):
    """Speculative decoding at full width, k = ``SPEC_K``, bf16 pool.

    (a) A scripted proposer drafts from phase 7's captured streams of the
    same 8 prompts, corrupting position i % 5 − 1 of its i-th proposal:
    full accepts, full rejects and partial accepts; three passes with the
    proposer's count reset between them, the second measured (it must
    capture nothing and repeat the first's streams), the third with a
    profiler window over its widest verify step.  Gates: the streams
    equal phase 7's by the margin rule; one split pass and one combine per
    layer per step; the pool drained; a speculative engine that never
    drafts captures as many (T, P) keys as the plain engine on the same
    traffic (k is no key), and the scripted engine one capture per key it
    saw.  (b) The default ``NGramProposer`` on prompts of a repeated
    phrase, a warm pass then a measured pass, beside the plain engine."""
    import torch
    from repro_torch.serving import EngineCore
    make = lambda **kw: EngineCore(cfg, params, device=DEV, **ENGINE, **kw)  # noqa: E731
    plain_captures = plain["captures_per_pass"][0]
    wave = [[(i, p) for i, p in enumerate(prompts)]]
    corrupt = lambda i, n: None if i % (SPEC_K + 1) == 0 else i % (SPEC_K + 1) - 1  # noqa: E731
    truth = {tuple(p): want[i] for i, p in enumerate(prompts)}

    def spec_engine():
        return make(speculative=True, spec_k=SPEC_K, proposer=ScriptedProposer(
            truth, cfg.vocab_size, corrupt))

    silent = lambda: make(speculative=True, spec_k=SPEC_K,  # noqa: E731
                          proposer=lambda s, k: [])
    eng = spec_engine()
    a0 = serve_waves(eng, wave)                      # captures every key
    kinds = acceptance_kinds(eng.proposer.log)
    eng.proposer.calls, eng.proposer.log = 0, []     # the same proposals again
    verify = [i for i, st in enumerate(a0["step_log"])
              if st["drafted"] and not st["prefill"]]
    if not verify:
        fail("spec (a): no step verified drafts without a prefill chunk")
    verify_at = max(verify, key=lambda i: (a0["step_log"][i]["lanes"], -i))
    a = serve_waves(eng, [[(100 + i, p) for i, p in wave[0]]])
    verify_ms = [st["ms"] for st in a["step_log"]
                 if st["drafted"] and not st["prefill"]]
    stats, traces = eng.spec_stats, eng.trace_count  # of the first two passes
    eng.proposer.calls, eng.proposer.log = 0, []     # a third, profiled pass
    window = serve_waves(eng, [[(200 + i, p) for i, p in wave[0]]], profile_at={
        verify_at: str(ROOT / "chiprun_out" / "traces" / "bf16_replayed_verify")
    })["windows"][verify_at]
    decode_window = plain["windows"]["replayed decode"]
    keys = sorted(set(a0["keys"]) | set(a["keys"]))
    if eng.pages_in_use:
        fail(f"spec (a): {eng.pages_in_use} pages in use after the drain")
    if traces != len(keys) or a["waves"][0]["captures"]:
        fail(f"spec (a): {traces} captures for {len(keys)} (T, P) keys, "
             f"{a['waves'][0]['captures']} in the second pass")
    if {u - 100: t for u, t in a["streams"].items()} != a0["streams"]:
        fail("spec (a): the second pass served other streams than the first")
    if min(kinds.values()) == 0:
        fail(f"spec (a): not every acceptance kind occurred: {kinds}")
    del eng
    torch.cuda.empty_cache()
    eng = silent()
    s0 = serve_waves(eng, wave)
    silent_captures = eng.trace_count
    if silent_captures != plain_captures:
        fail(f"spec: a never-drafting engine captured {silent_captures} keys, "
             f"the plain engine {plain_captures}")
    del eng
    torch.cuda.empty_cache()

    serve = lambda eng, targets: serve_waves(eng, wave, targets)  # noqa: E731
    rerun = lambda make_eng: fresh_run(make_eng, serve)  # noqa: E731
    want = dict(enumerate(want))
    forks = hold_by_margin("spec (a)", a0["streams"], want,
                           rerun(spec_engine), rerun(make))
    silent_forks = hold_by_margin("spec (a) never drafting", s0["streams"],
                                  want, rerun(silent), rerun(make))
    fa = dict(steps=a["steps"], launches=a["launches"], spec_stats=stats,
              acceptance_kinds=kinds, captures=traces, keys=keys,
              drafted=a["waves"][0]["drafted"],
              accepted=a["waves"][0]["accepted"],
              plain_captures=plain_captures, plain_steps=plain["steps"],
              plain_step_ms_p50=plain["step_ms_p50"],
              step_ms_p50=a["step_ms_p50"],
              step_ms_p99=a["step_ms_p99"], tok_s=a["tok_s"],
              peak_gib=a["peak_gib"], forks=forks, silent_forks=silent_forks,
              verify_steps=len(verify_ms),
              verify_step_ms_p50=float(np.median(verify_ms)),
              decode_step_ms_p50=plain["decode_step_ms_p50"],
              verify_window=window, verify_step=a["step_log"][verify_at])
    log(f"[spec (a)] scripted proposer, k {SPEC_K}: {a['steps']} steps "
        f"(phase 7: {plain['steps']}) in the second pass, "
        f"{a['waves'][0]['accepted']} of {a['waves'][0]['drafted']} drafts "
        f"accepted; both passes {stats}; proposals by outcome {kinds}; "
        f"streams = "
        f"phase 7's" + (f" save near-tie forks {forks}" if forks else "")
        + f"; captures {traces} for {len(keys)} keys {keys}, none in the "
        f"second pass; a "
        f"never-drafting engine {silent_captures} = the plain engine's"
        + (f" (near-tie forks {silent_forks})" if silent_forks else "")
        + f"; launches "
        f"{a['launches']} = layers × steps; step ms p50 "
        f"{a['step_ms_p50']:.2f} p99 {a['step_ms_p99']:.2f} (phase 7 p50 "
        f"{plain['step_ms_p50']:.2f}); {a['tok_s']:.1f} generated tok/s "
        f"(phase 7 {plain['tok_s']:.1f}); peak {a['peak_gib']:.2f} GiB; "
        f"{len(verify_ms)} verify steps (drafts, no prefill): host ms p50 "
        f"{np.median(verify_ms):.2f} against phase 7's 8-lane decode steps "
        f"{plain['decode_step_ms_p50']:.2f}; the profiled verify step "
        f"{a['step_log'][verify_at]}: {window['launches']} kernels, "
        f"{window['device_ms']:.3f} ms of device time (phase 7's replayed "
        f"decode step {decode_window['launches']}, "
        f"{decode_window['device_ms']:.3f} ms), by group "
        + json.dumps({k: round(v, 4) for k, v in window["by_group"].items()})
        + " against "
        + json.dumps({k: round(v, 4) for k, v in
                      decode_window["by_group"].items()}))

    phrases = phrase_prompts(cfg)
    waves = [[(i, p) for i, p in enumerate(phrases)],
             [(100 + i, p) for i, p in enumerate(phrases)]]
    fb = {}
    for arm, kw in (("ngram", dict(speculative=True, spec_k=SPEC_K)),
                    ("plain", {})):
        eng = make(**kw)
        r = serve_waves(eng, waves)
        m = r["waves"][1]
        fb[arm] = dict(
            steps=m["steps"], generated=m["generated"],
            drafted=m["drafted"], accepted=m["accepted"],
            acceptance=m["accepted"] / max(m["drafted"], 1),
            tokens_per_step=m["generated"] / m["steps"],
            step_ms_p50=float(np.percentile(m["step_ms"], 50)),
            step_ms_p99=float(np.percentile(m["step_ms"], 99)),
            tok_s=m["generated"] / m["wall_s"], captures=m["captures"],
            launches=r["launches"], streams=r["streams"],
            spec_stats=eng.spec_stats)
        del eng
        torch.cuda.empty_cache()

    serve = lambda eng, targets: serve_waves(eng, waves, targets)  # noqa: E731
    fb["forks"] = hold_by_margin(
        "spec (b)", fb["ngram"].pop("streams"), fb["plain"].pop("streams"),
        fresh_run(lambda: make(speculative=True, spec_k=SPEC_K), serve),
        fresh_run(make, serve))
    ng, pl = fb["ngram"], fb["plain"]
    log(f"[spec (b)] NGramProposer, k {SPEC_K}, 8 prompts of a 32-token phrase "
        f"× 8, measured pass: {ng['accepted']} of {ng['drafted']} drafts "
        f"accepted ({ng['acceptance']:.3f}); "
        f"{ng['tokens_per_step']:.3f} committed tokens per step "
        f"({ng['steps']} steps) against {pl['tokens_per_step']:.3f} "
        f"({pl['steps']}); step ms p50 {ng['step_ms_p50']:.2f} against "
        f"{pl['step_ms_p50']:.2f}, p99 {ng['step_ms_p99']:.2f} / "
        f"{pl['step_ms_p99']:.2f}; {ng['tok_s']:.1f} generated tok/s against "
        f"{pl['tok_s']:.1f}; captures in the measured pass {ng['captures']} / "
        f"{pl['captures']}; streams = the plain arm's"
        + (f" save near-tie forks {fb['forks']}" if fb["forks"] else ""))
    return dict(scripted=fa, ngram=fb)


def sampled_traffic(prompts):
    """Phase 7's prompts as (index, prompt, params): requests 0–3 greedy,
    4–6 temperature 0.8, top_k 50, top_p 0.95, seed 1000 + i, 7
    temperature 1.0 with no mask."""
    from repro_torch.serving import SamplingParams
    sps = {i: SamplingParams(temperature=0.8, top_k=50, top_p=0.95,
                             seed=1000 + i) for i in (4, 5, 6)}
    sps[7] = SamplingParams(temperature=1.0)
    return [(i, p, sps.get(i)) for i, p in enumerate(prompts)], sps


SAMPLER_GROUPS = (("lut_exp", "#1 lut_exp"), ("sort", "sort"),
                  ("scan", "scan"), ("cumsum", "scan"),
                  ("elementwise", "elementwise"),
                  ("vectorized", "elementwise"), ("reduce", "reduce"),
                  ("index", "gather / scatter"), ("gather", "gather / scatter"),
                  ("scatter", "gather / scatter"), ("Memcpy", "copy"),
                  ("Memset", "copy"))


def sampler_window(sampler, label):
    """One replay of the sampler graph under ``torch.profiler`` → its device
    time by kernel group (sort, scan, elementwise, #1, …); the replay's
    launch counts are put back."""
    import os
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.tracing import profile_summary
    counts = read_paged_counts()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sampler.call.replay()
        torch.cuda.synchronize()
    set_paged_counts(counts)
    tdir = ROOT / "chiprun_out" / "traces"
    os.makedirs(tdir, exist_ok=True)
    path = str(tdir / f"{label}_sampler.json")
    prof.export_chrome_trace(path)
    s = profile_summary(path, top=None)
    groups = {}
    for name, ms in s["by_name"].items():
        low = name.lower()
        g = next((grp for key, grp in SAMPLER_GROUPS if key.lower() in low),
                 "other")
        groups[g] = groups.get(g, 0.0) + ms
    os.remove(path)
    return dict(launches=s["launches"], device_ms=s["device_ms"],
                kernel_span_ms=s["kernel_span_ms"],
                by_group=dict(sorted(groups.items(), key=lambda kv: -kv[1])),
                top={k[:70]: v for k, v in list(s["by_name"].items())[:8]})


def sampler_vs_plain(logits, label):
    """The sampler at the engine's shape on the card against the same code
    on the CPU, on one step's real logits with phase 7c's params on 8
    lanes: key words, bits and uniforms bit for bit, the LUT exponential of
    the masked scores bit for bit, picks equal save near-ties of
    ``scores + g``.  Launches put back."""
    import torch
    from repro_torch.core import prng
    from repro_torch.core.lut_softmax import lut_log_softmax
    from repro_torch.kernels.lut_exp import lut_exp, lut_exp_ref
    from repro_torch.serving.sampling import (_masked_scores, _request_keys,
                                              sample_rows)
    counts = read_paged_counts()
    n, v = logits.shape
    cpu = dict(
        temperature=torch.tensor([0.0] * 4 + [0.8] * 3 + [1.0]),
        top_k=torch.tensor([0] * 4 + [50] * 3 + [0], dtype=torch.int32),
        top_p=torch.tensor([1.0] * 4 + [0.95] * 3 + [1.0]),
        seed=torch.tensor([0, 0, 0, 0, 1004, 1005, 1006, 0]),
        counter=torch.arange(16, 16 + n, dtype=torch.int64))
    dev = {k: t.to(DEV) for k, t in cpu.items()}
    kc = _request_keys(cpu["seed"], cpu["counter"])
    kd = _request_keys(dev["seed"], dev["counter"])
    bc, bd = prng.random_bits(*kc, v), prng.random_bits(*kd, v)
    uc, ud = (prng.uniform(b, prng.F32_TINY) for b in (bc, bd))
    if not (all(torch.equal(a, b.cpu()) for a, b in zip(kc, kd))
            and torch.equal(bc, bd.cpu())
            and torch.equal(uc.view(torch.int32), ud.cpu().view(torch.int32))):
        fail(f"sampled {label}: the card's key words, bits or uniforms differ "
             f"from the CPU's")
    x, _ = _masked_scores(logits, dev["temperature"], dev["top_k"],
                          dev["top_p"], lut_exp)
    if not torch.equal(lut_exp(x).view(torch.int32).cpu(),
                       lut_exp_ref(x.cpu()).view(torch.int32)):
        fail(f"sampled {label}: lut_exp at the sampler shape differs from its "
             f"plain version")
    got = sample_rows(logits, **dev).cpu()
    want = sample_rows(logits.cpu(), **cpu)
    forks = []
    for i in (got != want).nonzero().flatten().tolist():
        if cpu["temperature"][i] <= 0:
            fail(f"sampled {label}: greedy lane {i} differs card vs CPU")
        z = {}
        for side, row, dev_, exp in (("card", logits[i:i + 1], DEV, lut_exp),
                                     ("cpu", logits[i:i + 1].cpu(), "cpu",
                                      lut_exp_ref)):
            p = {k: t[i:i + 1].to(dev_) for k, t in cpu.items()}
            x, keep = _masked_scores(row, p["temperature"], p["top_k"],
                                     p["top_p"], exp)
            z[side] = ((lut_log_softmax(x, where=keep, exp=exp)
                        + prng.gumbel(*_request_keys(p["seed"], p["counter"]),
                                      v))[0].cpu().numpy(),
                       keep[0].cpu().numpy())
        (zd, kd_), (zc, kc_) = z["card"], z["cpu"]
        both = kc_ & kd_
        lead = float(zc[want[i]] - zc[got[i]])
        gap = 2 * float(np.abs(zc - zd)[both].max())
        if not 0 <= lead < gap:
            fail(f"sampled {label}: lane {i} draws {int(got[i])} on the card, "
                 f"{int(want[i])} on the CPU, lead {lead} not below {gap}")
        forks.append(dict(lane=i, lead=lead, gap=gap))
    set_paged_counts(counts)
    return forks


def phase_sampled(cfg, params, kv_quant: bool, prompts, greedy_streams,
                  plain):
    """Seeded sampling through the captured step at full width (phase 7c):
    ``sampled_traffic`` through a captured engine (the main path: two
    passes capture the (T, P) keys and the one sampler graph, then
    ``mark_warm()`` and a measured pass), an eager engine, each sampled
    request served alone, a pool small enough to force preemptions, and an
    all-greedy pass.  Gates: captured = eager bit for bit; the greedy
    requests' streams equal phase 7's, the sampled ones alone equal them
    batched, and the preempted pass's equal the roomy one's, each save a
    near-tie fork (``hold_by_margin``); two LUT-exp launches on every step
    that samples and none on any other; no capture after ``mark_warm()``;
    the sampler on the card equals its CPU version on the same logits.
    → (facts, the captured engine)."""
    import torch
    from repro_torch.serving import EngineCore
    c = cfg.replace(kv_quant=kv_quant)
    tag = "int8" if kv_quant else "bf16"
    label = f"sampled {tag}"
    make = lambda **kw: EngineCore(c, params, device=DEV, **dict(ENGINE, **kw))  # noqa: E731
    traffic, sps = sampled_traffic(prompts)
    wave = lambda uid0=0: [[(uid0 + i, p, sp) for i, p, sp in traffic]]  # noqa: E731
    ce = make()
    first = serve_waves(ce, wave())
    second = serve_waves(ce, wave(100))
    if second["waves"][0]["captures"] or ce.graphs.sampler_captures != 1:
        fail(f"{label}: the second pass captured {second['waves'][0]['captures']}"
             f" step keys; {ce.graphs.sampler_captures} sampler captures")
    if {u - 100: t for u, t in second["streams"].items()} != first["streams"]:
        fail(f"{label}: the second pass served other streams than the first")
    ce.obs.mark_warm()
    m = serve_waves(ce, wave(200))     # the main path: counts zeroed around it
    retraces = int(ce.obs.registry.value("step_retraces_total"))
    if retraces or ce.graphs.sampler_captures != 1:
        fail(f"{label}: {retraces} step captures after mark_warm(), "
             f"{ce.graphs.sampler_captures} sampler captures")
    if {u - 200: t for u, t in m["streams"].items()} != first["streams"]:
        fail(f"{label}: the measured pass served other streams")
    sampled_steps = sum(st["sampled"] for st in m["step_log"])
    if not sampled_steps or m["launches"]["lut_exp"] != 2 * sampled_steps:
        fail(f"{label}: {m['launches']['lut_exp']} LUT-exp launches over "
             f"{sampled_steps} sampling steps (expected 2 each, and none on "
             f"the {m['steps'] - sampled_steps} steps that sample nothing)")
    sampled_ms = [st["ms"] for st in m["step_log"]
                  if st["sampled"] and not st["prefill"]
                  and st["decode"] == ENGINE["lanes"]]
    window = sampler_window(ce.graphs.sampler, tag)
    counts = read_paged_counts()
    sampler_ms = cuda_ms(lambda: ce.graphs.sampler.call.replay())
    set_paged_counts(counts)
    card_forks = sampler_vs_plain(ce.graphs.logits.clone(), tag)
    g = serve_waves(ce, [[(400 + i, p) for i, p in enumerate(prompts[:4])]])
    if g["launches"]["lut_exp"] or any(st["sampled"] for st in g["step_log"]):
        fail(f"{label}: an all-greedy pass ran the sampler "
             f"({g['launches']['lut_exp']} LUT-exp launches)")
    if ce.pages_in_use:
        fail(f"{label}: {ce.pages_in_use} pages in use after the drain")

    ee = make(capture=False)
    eager = serve_waves(ee, wave())
    del ee
    torch.cuda.empty_cache()
    if eager["streams"] != first["streams"]:
        fail(f"{label}: the captured arm's streams differ from the eager arm's")

    serve = lambda waves: lambda eng, targets: serve_waves(eng, waves, targets)  # noqa: E731
    greedy_wave = [[(i, p) for i, p in enumerate(prompts)]]
    greedy_forks = hold_by_margin(
        f"{label} greedy vs phase 7",
        {u: first["streams"][u] for u in range(4)},
        {u: greedy_streams[u] for u in range(4)},
        fresh_run(make, serve(wave())), fresh_run(make, serve(greedy_wave)))
    alone_waves = [[(i, p, sp)] for i, p, sp in traffic if sp is not None]
    alone = serve_waves(make(), alone_waves)["streams"]
    torch.cuda.empty_cache()
    alone_forks = hold_by_margin(
        f"{label} alone vs batched", alone,
        {u: first["streams"][u] for u in alone},
        fresh_run(make, serve(alone_waves)), fresh_run(make, serve(wave())),
        sampling=sps)
    need = sum(-(-(len(p) + MAX_NEW) // ENGINE["page_size"]) for p in prompts)
    tight_pages = max(need // 2, max(-(-(len(p) + MAX_NEW)
                                       // ENGINE["page_size"])
                                     for p in prompts) + 2)
    tight = serve_waves(make(num_pages=tight_pages), wave())
    torch.cuda.empty_cache()
    preempted = sum(st["preempted"] for st in tight["step_log"])
    if not preempted:
        fail(f"{label}: a pool of {tight_pages} pages forced no preemption")
    tight_forks = hold_by_margin(
        f"{label} preempted vs roomy", tight["streams"], first["streams"],
        fresh_run(lambda: make(num_pages=tight_pages), serve(wave())),
        fresh_run(make, serve(wave())), sampling=sps)
    facts = dict(
        pool=tag, steps=m["steps"], sampled_steps=sampled_steps,
        launches=m["launches"], step_ms_p50=m["step_ms_p50"],
        step_ms_p99=m["step_ms_p99"], tok_s=m["tok_s"],
        peak_gib=m["peak_gib"],
        greedy_step_ms_p50=plain["step_ms_p50"],
        greedy_step_ms_p99=plain["step_ms_p99"], greedy_tok_s=plain["tok_s"],
        sampled_decode_step_ms_p50=(float(np.median(sampled_ms))
                                    if sampled_ms else None),
        greedy_decode_step_ms_p50=plain["decode_step_ms_p50"],
        sampler_replay_ms=sampler_ms, sampler_window=window,
        step_retraces_total=retraces, captures=ce.graphs.captures,
        sampler_captures=ce.graphs.sampler_captures,
        greedy_forks=greedy_forks, alone_forks=alone_forks,
        tight_pages=tight_pages, preemptions=preempted,
        tight_forks=tight_forks, card_vs_cpu_forks=card_forks,
        streams=first["streams"])
    log(f"[sampled {tag}] requests 4–7 sampled: captured = eager bit for "
        f"bit; greedy requests = phase 7's"
        + (f" save near-tie forks {greedy_forks}" if greedy_forks else "")
        + f"; each sampled request alone = batched"
        + (f" save forks {alone_forks}" if alone_forks else "")
        + f"; a {tight_pages}-page pool: {preempted} preemptions, streams "
        f"unchanged" + (f" save forks {tight_forks}" if tight_forks else "")
        + f"; card = CPU sampler on one step's logits"
        + (f" save forks {card_forks}" if card_forks else "")
        + f"; measured pass: {m['steps']} steps ({sampled_steps} sampling), "
        f"LUT-exp launches {m['launches']['lut_exp']} = 2 × sampling steps, "
        f"none in an all-greedy pass; captures {ce.graphs.captures} + 1 "
        f"sampler, 0 after mark_warm(); step ms p50 {m['step_ms_p50']:.2f} "
        f"p99 {m['step_ms_p99']:.2f} (phase 7 greedy "
        f"{plain['step_ms_p50']:.2f} / {plain['step_ms_p99']:.2f}); 8-lane "
        f"decode steps that sample: host ms p50 "
        + (f"{np.median(sampled_ms):.2f}" if sampled_ms else "n/a")
        + f" (phase 7 {plain['decode_step_ms_p50']:.2f}); "
        f"{m['tok_s']:.1f} generated tok/s (phase 7 {plain['tok_s']:.1f}); "
        f"peak {m['peak_gib']:.2f} GiB; the sampler graph alone "
        f"{sampler_ms:.4f} ms (CUDA events, median of 20), one replay's "
        f"{window['launches']} kernels {window['device_ms']:.4f} ms of device "
        f"time by group "
        + json.dumps({k: round(v, 4) for k, v in window["by_group"].items()})
        + "; top " + json.dumps({k: round(v, 4)
                                 for k, v in window["top"].items()}))
    return facts, ce


def phase_front_door(eng, prompts, want):
    """The async front door on the warm bf16 engine of phase 7c (phase 7d):
    8 clients at once stream exactly the batch streams; a second pass with
    staggered arrivals and one client cancelled after 4 tokens (its pages
    free before the next step) read through ``summary()``; one scrape of
    ``/metrics`` on 127.0.0.1."""
    import asyncio
    from repro_torch.serving import (AsyncLMServer, Request,
                                     start_metrics_server)
    traffic, _ = sampled_traffic(prompts)
    cancel_uid, cancel_after = 605, 4
    seen = {"aborted": None, "violations": []}
    inner_step, inner_abort = eng.step, eng.abort

    def resident():
        s = eng.scheduler
        return {r.req.uid for r in s.running} | {r.req.uid for r in s.waiting}

    def step():
        if seen["aborted"] in resident():
            seen["violations"].append(eng.obs.registry.value("steps_total"))
        return inner_step()

    def abort(uid):
        out = inner_abort(uid)
        seen["aborted"] = uid
        return out

    eng.step, eng.abort = step, abort

    async def consume(server, req, delay=0.0, cancel=None):
        await asyncio.sleep(delay)
        toks, agen = [], server.generate(req)
        try:
            async for tok in agen:
                toks.append(tok)
                if cancel is not None and len(toks) >= cancel:
                    break
        finally:
            await agen.aclose()
        return toks

    def reqs(uid0):
        return [Request(uid=uid0 + i, prompt=p, max_new=MAX_NEW, sampling=sp)
                for i, p, sp in traffic]

    async def burst():
        async with AsyncLMServer(eng) as server:
            outs = await asyncio.gather(*[consume(server, r)
                                          for r in reqs(500)])
        return outs, server.summary()

    async def staggered():
        server = AsyncLMServer(eng)
        exporter = await start_metrics_server(server.obs.registry, port=0)
        try:
            async with server:
                outs = await asyncio.gather(*[
                    consume(server, r, delay=0.02 * i,
                            cancel=cancel_after if r.uid == cancel_uid
                            else None)
                    for i, r in enumerate(reqs(600))])
                tpot = server.obs.h_stream_tpot_ms.percentile(
                    0.50, skip=int(server._window["tpot_n"]))
            port = exporter.sockets[0].getsockname()[1]
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            writer.write(b"GET /metrics HTTP/1.0\r\n\r\n")
            await writer.drain()
            body = await reader.read()
            writer.close()
            await writer.wait_closed()
        finally:
            exporter.close()
            await exporter.wait_closed()
        return outs, server.summary(), tpot, body

    t0 = time.perf_counter()
    outs, s1 = asyncio.run(burst())
    t_burst = time.perf_counter() - t0
    if {i: t for i, t in enumerate(outs)} != want:
        fail("front door: the streamed tokens differ from EngineCore.run's")
    t0 = time.perf_counter()
    outs, s2, tpot_p50, body = asyncio.run(staggered())
    t_stag = time.perf_counter() - t0
    del eng.step, eng.abort          # the spies (and their cycle through eng)
    if seen["aborted"] != cancel_uid or seen["violations"]:
        fail(f"front door: the cancelled request was aborted as "
             f"{seen['aborted']}, resident at steps {seen['violations']}")
    if len(outs[cancel_uid - 600]) != cancel_after or s2["cancelled"] != 1:
        fail(f"front door: the cancelled client saw "
             f"{len(outs[cancel_uid - 600])} tokens, summary {s2}")
    for i, t in enumerate(outs):
        if i != cancel_uid - 600 and t != want[i]:
            fail(f"front door: staggered client {i} streamed another stream")
    if eng.pages_in_use:
        fail(f"front door: {eng.pages_in_use} pages in use after the drain")
    head = body.split(b"\r\n", 1)[0]
    if b"200" not in head or b"stream_requests_total" not in body:
        fail(f"front door: /metrics answered {head!r}")
    facts = dict(burst=s1, burst_s=t_burst, staggered=s2,
                 staggered_s=t_stag, tpot_ms_p50=tpot_p50,
                 metrics_bytes=len(body))
    log(f"[front door] 8 clients at once: streams = EngineCore.run's, "
        f"{s1['requests']} requests in {t_burst:.2f} s, {s1['req_s']:.2f} "
        f"req/s, TTFT p50 {s1['ttft_ms_p50']:.1f} p99 {s1['ttft_ms_p99']:.1f} "
        f"ms, TPOT mean {s1['tpot_ms']:.2f} ms; staggered (20 ms apart, "
        f"request {cancel_uid} cancelled after {cancel_after} tokens, its "
        f"pages free before the next step): {s2['requests']} finished, "
        f"{s2['cancelled']} cancelled in {t_stag:.2f} s, {s2['req_s']:.2f} "
        f"req/s, TTFT p50 {s2['ttft_ms_p50']:.1f} p99 "
        f"{s2['ttft_ms_p99']:.1f} ms, TPOT p50 {tpot_p50:.2f} ms (mean "
        f"{s2['tpot_ms']:.2f}), {s2['steps']} steps; /metrics on 127.0.0.1: "
        f"{head.decode()}, {len(body)} bytes")
    return facts


# ------------------------------------------------------ the padded oracle --

#: phase 7f's block of the step check: (live rows, kv_len) per lane at
#: C = ENGINE["chunk_size"]: a full chunk mid-prompt, a prompt's first
#: 100 tokens (156 padding rows at positions −156 … −1), five decodes (at
#: kv 37 the padding rows reach −218) and an idle lane (kv_len 0)
PADDED_BLOCK = ([(ENGINE["chunk_size"], 3 * ENGINE["chunk_size"]), (100, 100)]
                + [(1, kv) for kv in KV_LENS[:5]] + [(0, 0)])


def padded_pass(eng, prompts, targets=frozenset()):
    """Serve phase 7's requests once through the padded engine ``eng``;
    kernel counts zeroed just before and read just after → facts of the
    pass, and the (lanes, V) logits row of every (uid, token index) in
    ``targets``, read from the step that committed the token (the padded
    step is eager: its own logits, no rerun)."""
    import torch
    from repro_torch.serving import Request
    reqs, seen = {}, {}
    inner_step, inner_plans = eng._step, eng.scheduler.plans_for

    def step(**a):
        seen["logits"] = inner_step(**a)
        return seen["logits"]

    def plans_for(wants):
        seen["plans"], pre = inner_plans(wants)
        return seen["plans"], pre
    eng._step, eng.scheduler.plans_for = step, plans_for
    for i, p in enumerate(prompts):
        reqs[i] = Request(uid=i, prompt=p, max_new=MAX_NEW)
        eng.submit(reqs[i])
    eng.finished.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_paged_counts()
    step_ms, kinds, logits, steps, rows = [], [], {}, 0, [0, 0]
    t0 = time.perf_counter()
    while eng.scheduler.has_work():
        before = {u: len(r.tokens) for u, r in reqs.items()}
        s0 = time.perf_counter()
        out = eng.step()
        step_ms.append((time.perf_counter() - s0) * 1e3)
        if not out.lanes:
            continue
        steps += 1
        rows[0] += out.live_rows
        rows[1] += out.padded_rows
        kinds.append("decode" if out.padded_rows == ENGINE["lanes"]
                     else "chunk")
        if out.kernel_config is not None:
            fail(f"padded step recorded a kernel config {out.kernel_config}")
        for i, plan in enumerate(seen["plans"]):
            u = plan.run.req.uid
            for j in range(before[u], len(reqs[u].tokens)):
                if (u, j) in targets:
                    logits[u, j] = seen["logits"][i].float().cpu().numpy()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_paged_counts()
    eng._step = inner_step
    del eng.scheduler.plans_for                     # the spy
    streams = {u: list(r.tokens) for u, r in reqs.items()}
    if any(len(t) != MAX_NEW or not all(0 <= x < eng.cfg.vocab_size for x in t)
           for t in streams.values()):
        fail("padded engine: a request did not produce MAX_NEW in-vocab "
             "tokens")
    for kernel in ("paged_attention", "paged_combine"):
        if launches[kernel] != eng.cfg.num_layers * steps:
            fail(f"padded engine: {kernel} launched {launches[kernel]} times, "
                 f"expected layers × steps = {eng.cfg.num_layers} × {steps}")
    if eng.pages_in_use != 0 or eng.kv.free_pages != eng.kv.num_pages:
        fail(f"padded engine: {eng.pages_in_use} pages in use after the drain")
    gen = sum(len(t) for t in streams.values())
    return dict(streams=streams, logits=logits, steps=steps,
                decode_steps=kinds.count("decode"),
                chunk_steps=kinds.count("chunk"), launches=launches,
                wall_s=wall, tok_s=gen / wall, live_rows=rows[0],
                padded_rows=rows[1],
                step_ms_p50=float(np.percentile(step_ms, 50)),
                step_ms_p99=float(np.percentile(step_ms, 99)),
                decode_step_ms_p50=float(np.median(
                    [t for t, k in zip(step_ms, kinds) if k == "decode"])),
                chunk_step_ms_p50=float(np.median(
                    [t for t, k in zip(step_ms, kinds) if k == "chunk"])),
                trace_count=eng.trace_count,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)


def swap_block_attention(fn):
    """Put ``fn`` where the padded branch calls kernel #2's block entry
    (``models/layers.py`` for int8 pools, the registry's ``paged``
    backend for float ones) → the previous function, to put back."""
    import repro_torch.core.attention_api as A
    import repro_torch.models.layers as L
    old = L.paged_attention
    L.paged_attention = A.paged_attention = fn
    return old


def make_block(spec, c, cfg, pool, seed):
    """A padded block of ``spec`` ((live rows, kv_len) per lane) at
    width ``c`` over ``pool``'s pages, drawn without replacement from a
    shuffled page order → (tokens, table, kv_len, q_len) on the card, and
    each row's position (kv_len − c + i)."""
    import torch
    rng = np.random.default_rng(seed)
    ps, n_pages = pool["k"].shape[3], pool["k"].shape[1] - 1
    need = [-(-kv // ps) for _, kv in spec]
    width = 1 << (max(max(need), 1) - 1).bit_length()
    perm = rng.permutation(n_pages)
    table = np.full((len(spec), width), n_pages, np.int32)
    off = 0
    for i, k in enumerate(need):
        table[i, :k] = perm[off:off + k]
        off += k
    tokens = rng.integers(0, cfg.vocab_size, (len(spec), c)).astype(np.int32)
    kv_len = np.array([kv for _, kv in spec], np.int32)
    q_len = np.array([n for n, _ in spec], np.int32)
    pos = kv_len[:, None] - c + np.arange(c)[None]
    dev = lambda a: torch.from_numpy(a).to(DEV)  # noqa: E731
    return tuple(map(dev, (tokens, table, kv_len, q_len))), pos


def padded_block_vs_plain(cfg, params, label, floor):
    """One padded block step (``PADDED_BLOCK`` at C = chunk_size) over a
    pool of random history at the depth of ``step_check_cut``, through
    kernel #2's block entry and through its plain version (at 8 pages per
    online-softmax step and at 1), with phase 7's rule
    (``phase_step_vs_plain``): the kernel within 3× the spread between the
    two plain schedules (``floor`` at least), greedy picks equal on every
    lane whose top-2 margin exceeds twice the gap.  Every layer's kernel
    output is finite, and its rows that see no key — the idle lane's, and
    padding rows at negative positions — are exactly zero, as the plain
    version's are.  Each run rewrites the block's rows with the same
    values before attending, so all three read the same history."""
    import torch
    from repro_torch.kernels.paged_attention import paged_attention_reference
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.models.lm import lm_prefill_chunk_paged, trunk_cache_init
    depth = cfg.num_layers
    cfg, params, _ = step_check_cut(cfg, params, None)
    pool = trunk_cache_init(cfg, ENGINE["num_pages"] + 1, ENGINE["page_size"],
                            DEV)
    g = torch.Generator(device=DEV).manual_seed(3)
    for leaf in pool.values():
        leaf.normal_(generator=g)
    c = ENGINE["chunk_size"]
    args, pos = make_block(PADDED_BLOCK, c, cfg, pool, seed=7)
    outs = []

    def recorded(*a, **kw):
        outs.append(paged_attention(*a, **kw))
        return outs[-1]

    def run(fn):
        old = swap_block_attention(fn)
        try:
            return lm_prefill_chunk_paged(cfg, params, args[0], pool,
                                          *args[1:])[0]
        finally:
            swap_block_attention(old)
    zero_paged_counts()
    k_logits = run(recorded)
    torch.cuda.synchronize()
    launches = read_paged_counts()
    p_logits = run(lambda *a, **kw: paged_attention_reference(
        *a, **{**kw, "block_pages": 8}))
    p1_logits = run(lambda *a, **kw: paged_attention_reference(
        *a, **{**kw, "block_pages": 1}))
    torch.cuda.synchronize()
    if launches["paged_attention"] != cfg.num_layers or \
            launches["paged_combine"] != cfg.num_layers:
        fail(f"padded {label} block: {launches} launches, not one split pass "
             f"and one combine per layer ({cfg.num_layers})")
    dead = torch.from_numpy(pos < 0).to(DEV)[:, None, :, None]   # (B,1,C,1)
    dead_rows = int((pos < 0).sum())
    for i, o in enumerate(outs):
        if not torch.isfinite(o).all():
            fail(f"padded {label} block: layer {i}'s kernel output not finite")
        if o.masked_select(dead).abs().max() != 0:
            fail(f"padded {label} block: layer {i}: a row that sees no key "
                 f"(idle lane, negative position) is not zero")
    for lg in (k_logits, p_logits, p1_logits):
        if lg.shape != (len(PADDED_BLOCK), cfg.vocab_size) or \
                not torch.isfinite(lg).all():
            fail(f"padded {label} block: logits {tuple(lg.shape)} not finite")
    err = float((k_logits - p_logits).abs().max())
    spread = float((p1_logits - p_logits).abs().max())
    tol = max(3.0 * spread, floor)
    top2 = torch.topk(p_logits, 2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1]).cpu().numpy()
    agree = (k_logits.argmax(-1) == p_logits.argmax(-1)).cpu().numpy()
    decided = margin > 2 * err
    log(f"[padded block {label}] lanes (live rows, kv_len) {PADDED_BLOCK} at "
        f"C {c}, {cfg.num_layers} of {depth} layers: kernel vs plain "
        f"max|Δlogit| {err:.3g}; plain 8-page vs 1-page schedule {spread:.3g} "
        f"(limit {tol:.3g}); greedy picks agree on {int(agree.sum())}/"
        f"{len(agree)} lanes, {int(decided.sum())} with a top-2 margin > "
        f"2×max|Δ|; {dead_rows} rows see no key: zero in every layer's "
        f"kernel output; launches {launches}")
    if err > tol:
        fail(f"padded {label} block logits differ by {err} > {tol}")
    if not agree[decided].all():
        fail(f"padded {label} block: greedy pick differs on a lane with a "
             f"clear margin")
    return dict(max_abs_logit=err, plain_schedule_spread=spread, limit=tol,
                agree=int(agree.sum()), decided=int(decided.sum()),
                lanes=len(agree), layers=cfg.num_layers,
                zero_rows=dead_rows, launches=launches)


def time_padded_block(spec, flush, seed):
    """Kernel #2's block entry (split pass + combine) at a padded block of
    ``spec`` ((live rows, kv_len) per lane; C the most live rows) over a
    bf16 pool at phase 7's widths, beside its plain version and SDPA on a
    gathered view (each lane's K/V padded to the longest lane, a boolean
    mask of each row's visible keys; exact exp, not the same function) →
    times, bound and error.  The bound counts what the call computes:
    every row of the block, padding rows included, sees its visible keys;
    each lane's kv_len rows are read once."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     paged_attention_reference)
    from repro_torch.kernels.paged_attention.ops import default_kv_split
    c = max(n for n, _ in spec)
    s = make_stream([(1, kv) for _, kv in spec], pool="bfloat16",
                    n_pages=ENGINE["num_pages"], seed=seed)
    hq, hkv, d, ps = s["hq"], s["hkv"], s["d"], s["k"].shape[2]
    g = torch.Generator(device=DEV).manual_seed(seed)
    q = torch.randn((len(spec), hq, c, d), generator=g, device=DEV).bfloat16()
    table = s["table"][s["cu"][:len(spec)].long()].contiguous()
    kv_len = torch.tensor([kv for _, kv in spec], dtype=torch.int32,
                          device=DEV)
    a = (q, s["k"], s["v"], table, kv_len)
    split = default_kv_split(ps)
    got = paged_attention(*a)
    want = paged_attention_reference(*a, block_pages=8, kv_split=split)
    err = bf16_ulps(got, want)
    if not err <= 1.0:
        fail(f"paged_attention block {spec}: {err:.2f} bf16 ulp beyond atol "
             f"2e-5 (limit 1)")
    lmax = max(kv for _, kv in spec)
    views = lane_views(s, range(len(spec)))
    kg = torch.cat([F.pad(k, (0, 0, 0, lmax - k.shape[2])) for k, _ in views])
    vg = torch.cat([F.pad(v, (0, 0, 0, lmax - v.shape[2])) for _, v in views])
    qpos = kv_len[:, None] - c + torch.arange(c, device=DEV)[None]   # (B, C)
    mask = (torch.arange(lmax, device=DEV)[None, None, :]
            <= qpos[:, :, None])[:, None]                       # (B,1,C,L)
    med = interleaved_ms({
        "ms": lambda: cuda_ms(lambda: paged_attention(*a), flush=flush),
        "library_ms": lambda: cuda_ms(lambda: F.scaled_dot_product_attention(
            q, kg, vg, attn_mask=mask), flush=flush)})
    plain = cuda_ms(lambda: paged_attention_reference(*a, block_pages=8),
                    iters=5, flush=flush)
    rows_kv = sum(kv for _, kv in spec)
    nbytes = (rows_kv * hkv * 2 * d * 2 + 2 * q.numel() * 2
              + table.numel() * 4 + kv_len.numel() * 4)
    vis = int(torch.clamp(qpos + 1, min=0).sum())
    flops = 4.0 * d * hq * vis
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    return dict(**med, plain_ms=plain, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                max_bf16_ulps=err, bytes=nbytes, flops=flops, kv_split=split,
                shape=f"({len(spec)} lanes, C {c}) block, (live rows, kv) "
                      f"{spec}, {hq} heads × {d}, ps {ps}, "
                      f"{table.shape[1]} table slots, bf16 pool, both "
                      f"launches; SDPA on a gathered bf16 view with a "
                      f"visibility mask")


def phase_padded(cfg, params, prompts, ragged, compiled):
    """Phase 7f, the padded oracle: ``EngineCore(mode="padded")`` serves
    phase 7's requests at full width on the bf16 and the int8 pool, with
    phase 7's resident weights.  Each pass: #2's split pass and combine
    each launched layers × steps (one per layer per block step, eager),
    the pool drained, and the greedy streams equal to phase 7's captured
    ragged streams (``ragged``) by the margin rule (``hold_by_margin``:
    the (lanes, C) block's products are not the (T,) stream's, so bf16
    streams may fork at near-ties).  Then one block step held against the
    plain version in bf16 and f32 (``padded_block_vs_plain``, which also
    holds the rows that see no key at zero), and #2 timed at the padded
    pass's two block shapes (``time_padded_block``).  → facts."""
    import torch
    from repro_torch.serving import EngineCore
    t0 = time.perf_counter()
    facts = {}
    wave = [[(i, p) for i, p in enumerate(prompts)]]
    for tag, kv_quant in (("bf16", False), ("int8", True)):
        c = cfg.replace(kv_quant=kv_quant)
        make = lambda c=c: EngineCore(c, params, device=DEV,  # noqa: E731
                                      mode="padded", **ENGINE)
        make_ragged = lambda c=c: EngineCore(c, params, device=DEV,  # noqa: E731
                                             **ENGINE)
        eng = make()
        run = padded_pass(eng, prompts)
        del eng
        torch.cuda.empty_cache()
        forks = hold_by_margin(
            f"padded {tag}", run["streams"], dict(enumerate(ragged[tag])),
            fresh_run(make, lambda e, t: padded_pass(e, prompts, t)),
            fresh_run(make_ragged, lambda e, t: serve_waves(e, wave,
                                                            targets=t)))
        ragged_p50 = compiled[tag]["step_ms_p50"]
        facts[tag] = dict({k: v for k, v in run.items()
                           if k not in ("streams", "logits")}, forks=forks,
                          ragged_captured_step_ms_p50=ragged_p50)
        log(f"[padded {tag}] {run['steps']} block steps ({run['decode_steps']} "
            f"decode at C 1, {run['chunk_steps']} at C "
            f"{ENGINE['chunk_size']}), {run['trace_count']} block shapes; "
            f"step ms p50 {run['step_ms_p50']:.2f} (decode "
            f"{run['decode_step_ms_p50']:.2f}, chunk "
            f"{run['chunk_step_ms_p50']:.2f}) p99 {run['step_ms_p99']:.2f}, "
            f"beside phase 7's captured ragged step p50 {ragged_p50:.2f}; "
            f"{run['tok_s']:.1f} generated tok/s; live / computed rows "
            f"{run['live_rows']} / {run['padded_rows']}; peak "
            f"{run['peak_gib']:.2f} GiB; launches {run['launches']} = layers "
            f"× steps; pool drained; streams equal phase 7's"
            + (f" save near-tie forks {forks}" if forks else "") + f"; {CARD[0]}")
    facts["block_bf16"] = padded_block_vs_plain(cfg, params, "bf16", 1e-2)
    c32 = cfg.replace(dtype="float32")
    cut, cut_params, _ = step_check_cut(c32, params, None)
    p32 = {k: v.float() for k, v in cut_params.items()}
    facts["block_f32"] = padded_block_vs_plain(cut, p32, "f32", 1e-3)
    del p32, cut_params
    torch.cuda.empty_cache()
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=DEV)
    flush = lambda: flush_buf.zero_()  # noqa: E731
    kv_lens = decode_kv_lens()
    n_chunk, kv_chunk = MIXED_CHUNK
    facts["time"] = {
        "decode block": time_padded_block([(1, kv) for kv in kv_lens], flush,
                                          seed=31),
        "chunk block": time_padded_block(
            [(n_chunk, kv_chunk)] + [(1, kv) for kv in kv_lens[:7]], flush,
            seed=32)}
    del flush_buf
    for k, t in facts["time"].items():
        log(f"[time] paged_attention padded {k} ({t['shape']}): kernel "
            f"{t['ms']:.4f} ms, sdpa {t['library_ms']:.4f} ms (medians of 5 "
            f"interleaved rounds), plain {t['plain_ms']:.3f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}: {t['bytes'] / 1e6:.1f} "
            f"MB, {t['flops'] / 1e9:.2f} GFLOP); {t['max_bf16_ulps']:.2f} bf16 "
            f"ulp beyond atol 2e-5; {CARD[0]}")
    facts["seconds"] = time.perf_counter() - t0
    log(f"[padded] phase 7f took {facts['seconds']:.1f} s")
    return facts


def step_check_cut(cfg, params, pool):
    """``cfg`` cut to ``STEP_CHECK_LAYERS`` layers, or two whole periods of
    its pattern where that is more (gemma3: 12), with the first layers'
    weights and pool leaves (views): the depth of the plain-attention step
    checks, whose plain schedules run on the host layer by layer."""
    from repro_torch.models.lm import layer_keys
    per = len(cfg.pattern)
    n = min(cfg.num_layers, per * max(2, -(-STEP_CHECK_LAYERS // per)))
    keys = set(layer_keys(cfg))
    cut = {k: (v[:n] if k in keys else v) for k, v in params.items()}
    return (cfg.replace(num_layers=n), cut,
            None if pool is None else {k: v[:n] for k, v in pool.items()})


def phase_step_vs_plain(cfg, params, pool, label: str, floor: float,
                        spec=None):
    """One ragged step at full width (7 decode lanes + a prefill chunk; or
    ``spec``'s (new rows, rows after) per lane) over ``pool``, at the depth
    of ``step_check_cut``, through the kernel and through the plain
    attention (passed explicitly, at 8 pages per online-softmax step and at
    1).  Each run rewrites the step's own rows before attending, so all
    three read the same history.

    Tolerance: the kernel must sit within 3× the spread between the two
    plain schedules on this very step (``floor`` at least) — in bf16 every
    attention output rounds once, so schedules land up to an ulp apart and
    the gap travels through the layers; in f32 only the sum order differs.
    Greedy picks must agree on every lane whose top-2 margin exceeds twice
    the measured gap."""
    import torch
    from repro_torch.kernels.autotune import resolve_config
    from repro_torch.kernels.paged_attention import (
        paged_attention_varlen_reference)
    from repro_torch.models.lm import lm_step_ragged
    from repro_torch.serving.scheduler import default_token_buckets
    depth = cfg.num_layers
    cfg, params, pool = step_check_cut(cfg, params, pool)
    rng = np.random.default_rng(7)
    spec = spec or [(1, kv) for kv in KV_LENS[1:]] + [(CHUNK, 3 * CHUNK)]
    ps, n_pages = pool["k"].shape[3], pool["k"].shape[1] - 1
    need = [-(-kv // ps) for _, kv in spec]
    perm = rng.permutation(n_pages)
    nq = np.array([n for n, _ in spec])
    live = int(nq.sum())
    buckets = default_token_buckets(ENGINE["lanes"] + ENGINE["chunk_size"])
    width = min(w for w in buckets if w >= live)
    pw = 1 << (max(need) - 1).bit_length()
    table = np.full((width, pw), n_pages, np.int32)            # scratch page
    cu = np.concatenate([[0], np.cumsum(nq)]).astype(np.int32)
    pos = np.zeros(width, np.int32)
    off = 0
    for i, (n, kv) in enumerate(spec):
        table[cu[i]:cu[i + 1], :need[i]] = perm[off:off + need[i]]
        off += need[i]
        pos[cu[i]:cu[i + 1]] = np.arange(kv - n, kv)
    tokens = np.zeros(width, np.int32)
    tokens[:live] = rng.integers(0, cfg.vocab_size, live)
    cu_full = np.full(ENGINE["lanes"] + 2, width, np.int32)
    cu_full[:len(cu)] = cu
    last_idx = (cu[1:] - 1).astype(np.int32)
    dev = lambda a: torch.from_numpy(a).to(DEV)  # noqa: E731
    args = (cfg, params, dev(tokens), pool, dev(table), dev(pos),
            dev(last_idx), dev(cu_full), resolve_config(cfg.name, "cuda"))
    k_logits = lm_step_ragged(*args)
    p_logits = lm_step_ragged(*args, attend=paged_attention_varlen_reference)
    p1_logits = lm_step_ragged(*args, attend=lambda *a, **kw: (
        paged_attention_varlen_reference(*a, **{**kw, "block_pages": 1})))
    torch.cuda.synchronize()
    for lg in (k_logits, p_logits, p1_logits):
        if lg.shape != (len(spec), cfg.vocab_size) or not torch.isfinite(lg).all():
            fail(f"{label} step: logits {tuple(lg.shape)} not finite")
    err = float((k_logits - p_logits).abs().max())
    spread = float((p1_logits - p_logits).abs().max())
    tol = max(3.0 * spread, floor)
    top2 = torch.topk(p_logits, 2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1]).cpu().numpy()
    agree = (k_logits.argmax(-1) == p_logits.argmax(-1)).cpu().numpy()
    decided = margin > 2 * err
    log(f"[step {label}] full-width ragged step ({live} live rows, width "
        f"{width}, {cfg.num_layers} of {depth} layers): kernel vs plain "
        f"attention "
        f"max|Δlogit| {err:.3g}; plain 8-page vs 1-page schedule "
        f"{spread:.3g} (limit {tol:.3g}); logit std "
        f"{float(p_logits.std()):.3f}; greedy picks agree on "
        f"{int(agree.sum())}/{len(agree)} lanes; {int(decided.sum())} lanes "
        f"with a top-2 margin > 2×max|Δ|, all must agree")
    if err > tol:
        fail(f"{label} step logits differ by {err} > {tol}")
    if not agree[decided].all():
        fail(f"{label} step: greedy pick differs on a lane with a clear margin")
    return dict(max_abs_logit=err, plain_schedule_spread=spread, limit=tol,
                agree=int(agree.sum()), decided=int(decided.sum()),
                lanes=len(agree), layers=cfg.num_layers)


def phase_step_f32(cfg, params):
    """The same step in f32: weights widened (the bf16 dict is consumed to
    make room), a fresh f32 pool with random history rows."""
    import torch
    from repro_torch.models.lm import trunk_cache_init
    c = cfg.replace(dtype="float32")
    for k in list(params):
        params[k] = params.pop(k).float()
    pool = trunk_cache_init(step_check_cut(c, params, None)[0],
                            ENGINE["num_pages"] + 1, ENGINE["page_size"], DEV)
    g = torch.Generator(device=DEV).manual_seed(3)
    for leaf in pool.values():
        leaf.normal_(generator=g)
    return phase_step_vs_plain(c, params, pool, "f32", floor=1e-3)


def attention_work(s, itemsize, window=None):
    """Bytes and operations the main-path attention call needs: every KV
    row some live row sees read once (values + int8 scales: with a
    ``window``, a lane's last ``window + n − 1`` rows), q read and out
    written once, the table and lengths; QKᵀ and P·V over each live row's
    visible columns."""
    hq, hkv, d = s["hq"], s["hkv"], s["d"]
    w = window or 1 << 62
    rows_kv = sum(min(kv, w + n - 1) for n, kv in s["spec"])
    scale_bytes = 2 * 4 if s["ks"] is not None else 0
    kv_bytes = rows_kv * hkv * (2 * d * s["k"].element_size() + scale_bytes)
    t = s["q"].shape[0]
    io = 2 * t * hq * d * itemsize + s["table"].numel() * 4
    vis = sum(sum(min(kv - n + i + 1, w) for i in range(n))
              for n, kv in s["spec"])
    flops = 4.0 * d * hq * vis
    return kv_bytes + io, flops


def q_blocks(s, bq=8):
    """The tiled call the varlen path makes for stream ``s``: (q-blocks,
    pools, block tables, block kv_len) and the int8 scales."""
    from repro_torch.kernels.paged_attention import q_block_layout
    hq, d = s["hq"], s["d"]
    rows, start, kvl, _ = q_block_layout(s["cu"], s["pos"], s["q"].shape[0], bq)
    qb = s["q"][rows.reshape(-1).long()].reshape(rows.shape[0], bq, hq, d)
    qb = qb.transpose(1, 2).contiguous()
    tbl = s["table"][start.long()].contiguous()
    return (qb, s["k"], s["v"], tbl, kvl), dict(k_scale=s["ks"], v_scale=s["vs"])


def lane_views(s, lanes):
    """Per lane of ``s`` (indices into its spec): the gathered contiguous K
    and V (dequantised for int8), as bf16 (1, Hkv, kv, D) views."""
    import torch
    ps = s["k"].shape[2]
    kf, vf = s["k"], s["v"]
    if s["ks"] is not None:
        kf = kf.float() * s["ks"][..., None]
        vf = vf.float() * s["vs"][..., None]
    out = []
    for i in lanes:
        kv = s["spec"][i][1]
        ids = s["table"][s["cu"][i].long(), :-(-kv // ps)].long()
        g = lambda pool: (pool[ids].transpose(0, 1).reshape(  # noqa: E731
            1, s["hkv"], -1, s["d"])[:, :, :kv].bfloat16())
        out.append((g(kf), g(vf)))
    return out


def paged_bound(s, itemsize, window=None):
    nbytes, flops = attention_work(s, itemsize, window)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, flops)


def time_paged(a, kw, library, flush, default):
    """Kernel #2 (both launches) on the tiled call ``a``/``kw`` (the
    engine's tuned config) beside the library yardstick ``library``, in
    interleaved rounds: ``ms`` and ``library_ms`` as a caller sees them
    (CUDA events from the host's call: the wrapper's host work shows where
    it outlasts the card's), the same two with a spin lead (``device_ms``,
    ``library_device_ms``: the card's work alone), the host time of one
    call of each (``host_ms``, ``library_host_ms``), and the device time of
    the same step at ``DEFAULT_CONFIG`` (``default``: its call's (a, kw);
    ``default_config_device_ms``)."""
    from repro_torch.kernels.paged_attention import paged_attention
    kernel = lambda: paged_attention(*a, **kw)  # noqa: E731
    med = interleaved_ms({
        "ms": lambda: cuda_ms(kernel, flush=flush),
        "library_ms": lambda: cuda_ms(library, flush=flush),
        "device_ms": lambda: cuda_ms(kernel, flush=flush, spin=True),
        "library_device_ms": lambda: cuda_ms(library, flush=flush, spin=True),
        "default_config_device_ms": lambda: cuda_ms(
            lambda: paged_attention(*default[0], **default[1]), flush=flush,
            spin=True)})
    return dict(med, host_ms=host_ms(kernel), library_host_ms=host_ms(library))


def paged_times(t) -> str:
    return (f"kernel {t['ms']:.4f} ms, sdpa {t['library_ms']:.4f} ms; device "
            f"alone (spin lead) kernel {t['device_ms']:.4f} ms, sdpa "
            f"{t['library_device_ms']:.4f} ms, DEFAULT_CONFIG "
            f"{t['default_config_device_ms']:.4f} ms; host per call kernel "
            f"{t['host_ms']:.4f} ms, sdpa {t['library_host_ms']:.4f} ms "
            f"(medians of 5 interleaved rounds)")


def tiled_calls(s, kc):
    """The tiled call of stream ``s`` at config ``kc`` and at
    ``DEFAULT_CONFIG``: ((a, kw) tuned, (a, kw) default, kc's pages per
    split)."""
    from repro_torch.kernels.paged_attention.ops import default_kv_split
    split = kc.kv_split or default_kv_split(s["k"].shape[2])
    a, kw = q_blocks(s, kc.block_q)
    a0, kw0 = q_blocks(s)
    return (a, dict(kw, kv_split=split)), (a0, kw0), split


def phase_timing(engine_facts, vocab):
    """Each kernel at the engine's decode-step shape (8 lanes decoding at
    the served requests' mid-decode lengths), beside its plain version, a
    library call and its bound; paged attention at the engine's tuned
    config (its block_q and pages per split) and, device alone, at
    ``DEFAULT_CONFIG``, also at a mixed step (one 256-token prefill chunk
    and 7 decodes) and a verify step."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import (
        paged_attention, paged_attention_reference, paged_attention_varlen,
        paged_attention_varlen_reference)
    from repro_torch.kernels.autotune import resolve_config
    from repro_torch.kernels.paged_attention.ops import paged_combine
    from repro_torch.kernels.paged_attention.ref import paged_combine_reference
    from repro_torch.serving.scheduler import default_token_buckets
    kc = resolve_config(MODEL, "cuda")
    bq = kc.block_q
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=DEV)
    flush = lambda: flush_buf.zero_()  # noqa: E731
    kv_lens = engine_facts["decode_kv_lens"]
    kernels = []
    for pool in ("bfloat16", "int8"):
        s = make_stream([(1, kv) for kv in kv_lens], pool=pool,
                        n_pages=ENGINE["num_pages"], seed=11)
        hq, d, ps = s["hq"], s["d"], s["k"].shape[2]
        (a, kw), default, split = tiled_calls(s, kc)
        plain_kw = dict(kw, block_pages=8)
        got = paged_attention(*a, **kw)
        want = paged_attention_reference(*a, **plain_kw)
        err = float((got.float() - want.float()).abs().max())
        plain = cuda_ms(lambda: paged_attention_reference(*a, **plain_kw),
                        iters=5, flush=flush)
        # yardstick: SDPA (exact exp, not the same function) over a gathered
        # contiguous bf16 view padded to the longest lane, with a length mask
        lmax = max(kv_lens)
        views = lane_views(s, range(8))
        kg = torch.cat([F.pad(k, (0, 0, 0, lmax - k.shape[2])) for k, _ in views])
        vg = torch.cat([F.pad(v, (0, 0, 0, lmax - v.shape[2])) for _, v in views])
        qd = s["q"][:8].reshape(8, 1, hq, d).transpose(1, 2).contiguous()
        mask = (torch.arange(lmax, device=DEV)[None, :]
                < torch.tensor(kv_lens, device=DEV)[:, None])[:, None, None]
        entry = time_paged(a, kw, lambda: F.scaled_dot_product_attention(
            qd, kg, vg, attn_mask=mask), flush, default)
        bound, bound_by, nbytes, flops = paged_bound(s, 2)
        name = "paged_attention" if pool == "bfloat16" else "paged_attention_int8"
        entry = dict(
            launches=engine_facts["launches"][pool]["paged_attention"],
            launches_by_path={k: v["paged_attention"] for k, v in
                              engine_facts["paths"].items()},
            max_abs_err=err, **entry, kernel_ms=entry["ms"], plain_ms=plain,
            bound_ms=bound, bound_by=bound_by, kv_split=split, block_q=bq,
            kernel_config=kc.describe(),
            shape=f"decode step: 8 lanes, kv {kv_lens}, block_q {bq}, "
                  f"{hq} heads × {d}, ps {ps}, {s['table'].shape[1]} table "
                  f"slots, {pool} pool; both launches (split pass + combine)")
        if pool == "bfloat16":
            kernels.append(dict(
                name=name, route="cuda",
                source="src/repro_torch/csrc/paged_attention.cu",
                replaces="src/repro/kernels/paged_attention/kernel.py:132",
                **entry,
                library="scaled_dot_product_attention over a gathered bf16 "
                        "view (exact exp, not the same function)"))
            decode = s
        else:                        # the same kernel over an int8 pool
            kernels[-1]["int8_pool"] = entry
        log(f"[time] {name}: {paged_times(entry)}; plain {plain:.3f} ms, bound "
            f"{bound:.4f} ms ({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")

    # the mixed step: one 256-token prefill chunk and 7 decode lanes in one
    # stream of the scheduler's bucket width, bf16 pool
    n_chunk, kv_chunk = MIXED_CHUNK
    spec = [(n_chunk, kv_chunk)] + [(1, kv) for kv in kv_lens[:7]]
    live = sum(n for n, _ in spec)
    width = min(w for w in default_token_buckets(
        ENGINE["lanes"] + ENGINE["chunk_size"]) if w >= live)
    s = make_stream(spec, pool="bfloat16", n_pages=ENGINE["num_pages"],
                    seed=12, width=width)
    (a, kw), default, split = tiled_calls(s, kc)
    plain_kw = dict(kw, block_pages=8)
    got = paged_attention(*a, **kw)
    want = paged_attention_reference(*a, **plain_kw)
    mixed_err = float((got.float() - want.float()).abs().max())
    mixed_plain = cuda_ms(lambda: paged_attention_reference(*a, **plain_kw),
                          iters=5, flush=flush)
    views = lane_views(s, range(len(spec)))
    qc = s["q"][:n_chunk].transpose(0, 1)[None]               # (1, Hq, n, D)
    qpos = kv_chunk - n_chunk + torch.arange(n_chunk, device=DEV)
    cmask = torch.arange(kv_chunk, device=DEV)[None, :] <= qpos[:, None]
    lmax = max(kv for _, kv in spec[1:])
    kd = torch.cat([F.pad(k, (0, 0, 0, lmax - k.shape[2])) for k, _ in views[1:]])
    vd = torch.cat([F.pad(v, (0, 0, 0, lmax - v.shape[2])) for _, v in views[1:]])
    qd = s["q"][n_chunk:live].reshape(7, 1, s["hq"], s["d"]).transpose(1, 2)
    qd = qd.contiguous()
    dmask = (torch.arange(lmax, device=DEV)[None, :] < torch.tensor(
        [kv for _, kv in spec[1:]], device=DEV)[:, None])[:, None, None]
    mixed = time_paged(a, kw, lambda: (
        F.scaled_dot_product_attention(qc, *views[0], attn_mask=cmask),
        F.scaled_dot_product_attention(qd, kd, vd, attn_mask=dmask)), flush,
        default)
    bound, bound_by, nbytes, flops = paged_bound(s, 2)
    kernels[0]["mixed_step"] = dict(
        **mixed, plain_ms=mixed_plain, bound_ms=bound, bound_by=bound_by,
        max_abs_err=mixed_err, kv_split=split, block_q=bq,
        library="two scaled_dot_product_attention calls on gathered bf16 "
                "views (the chunk with its causal mask; the 7 decodes)",
        shape=f"one {n_chunk}-token chunk at kv {kv_chunk} + 7 decodes at "
              f"kv {kv_lens[:7]}, stream width {width}, block_q {bq}, bf16 "
              f"pool")
    log(f"[time] paged_attention mixed step ({kernels[0]['mixed_step']['shape']}"
        f"): {paged_times(mixed)}; plain {mixed_plain:.3f} ms, bound "
        f"{bound:.4f} ms ({bound_by}: {nbytes / 1e6:.1f} MB, "
        f"{flops / 1e9:.2f} GFLOP); max|Δ| {mixed_err:.3g}")

    # the verify step: each of the 8 decode lanes streams its decode row and
    # SPEC_K drafts, 1 + SPEC_K rows in one q-block, at the decode shape's
    # lengths (the rows sit at kv − 1 … kv + SPEC_K − 1), bf16 pool
    rows = 1 + SPEC_K
    spec = [(rows, kv + SPEC_K) for kv in kv_lens]
    width = min(w for w in default_token_buckets(
        ENGINE["lanes"] + ENGINE["chunk_size"]) if w >= rows * len(spec))
    s = make_stream(spec, pool="bfloat16", n_pages=ENGINE["num_pages"],
                    seed=14, width=width)
    (a, kw), default, split = tiled_calls(s, kc)
    plain_kw = dict(kw, block_pages=8)
    vkw = dict(cu_seqlens=s["cu"], block_q=bq, block_pages=8, kv_split=split,
               k_scale=None, v_scale=None)
    varg = (s["q"], s["k"], s["v"], s["table"], s["pos"])
    live = slice(0, s["live"])
    got = paged_attention_varlen(*varg, **vkw)[live]
    want = paged_attention_varlen_reference(*varg, **vkw)[live]
    verify_err = float((got.float() - want.float()).abs().max())
    verify_ulps = bf16_ulps(got, want)
    if not verify_ulps <= 1.0:
        fail(f"paged_attention at the verify shape: {verify_ulps:.2f} bf16 "
             f"ulp beyond atol 2e-5 (limit 1)")
    verify_plain = cuda_ms(lambda: paged_attention_reference(*a, **plain_kw),
                           iters=5, flush=flush)
    lmax = max(kv for _, kv in spec)
    views = lane_views(s, range(len(spec)))
    kv_ = torch.tensor([kv for _, kv in spec], device=DEV)
    kg = torch.cat([F.pad(k, (0, 0, 0, lmax - k.shape[2])) for k, _ in views])
    vg = torch.cat([F.pad(v, (0, 0, 0, lmax - v.shape[2])) for _, v in views])
    qv = s["q"][:rows * len(spec)].reshape(len(spec), rows, s["hq"], s["d"])
    qv = qv.transpose(1, 2).contiguous()
    seen_to = kv_[:, None] - rows + 1 + torch.arange(rows, device=DEV)[None]
    vmask = (torch.arange(lmax, device=DEV)[None, None, :]
             < seen_to[:, :, None])[:, None]
    verify = time_paged(a, kw, lambda: F.scaled_dot_product_attention(
        qv, kg, vg, attn_mask=vmask), flush, default)
    bound, bound_by, nbytes, flops = paged_bound(s, 2)
    kernels[0]["verify_step"] = dict(
        **verify, plain_ms=verify_plain, bound_ms=bound, bound_by=bound_by,
        max_abs_err=verify_err, kv_split=split, block_q=bq,
        library="scaled_dot_product_attention on gathered bf16 views, each "
                "lane's 1 + k rows with their causal mask",
        shape=f"{len(spec)} lanes × {rows} rows (decode row + {SPEC_K} "
              f"drafts) at kv {[kv for _, kv in spec]}, stream width {width}, "
              f"{s['table'].shape[1]} table slots, block_q {bq}, bf16 pool")
    log(f"[time] paged_attention verify step ({kernels[0]['verify_step']['shape']}"
        f"): {paged_times(verify)}; plain {verify_plain:.3f} ms, bound "
        f"{bound:.4f} ms ({bound_by}: {nbytes / 1e6:.1f} MB, "
        f"{flops / 1e9:.2f} GFLOP); max|Δ| {verify_err:.3g}, "
        f"{verify_ulps:.2f} bf16 ulp beyond atol 2e-5 (limit 1)")

    # the combine alone, at the decode step's workspace shape: partials as
    # the split pass leaves them, never-written splits NaN
    (a, _), _, split = tiled_calls(decode, kc)
    kvl, ps = a[4], decode["k"].shape[2]
    nb, hkv, rows, d = a[0].shape[0], decode["hkv"], a[0].shape[2], decode["d"]
    n_split = -(-a[3].shape[1] // split)
    g = torch.Generator(device=DEV).manual_seed(13)
    pm = torch.randn((nb, hkv, n_split, rows), generator=g, device=DEV) * 3
    pl = torch.rand((nb, hkv, n_split, rows), generator=g, device=DEV) * 40 + 1
    pa = torch.randn((nb, hkv, n_split, rows, d), generator=g,
                     device=DEV) * pl[..., None]
    live_n = torch.clamp((kvl.long() + ps - 1) // ps + split - 1, min=0) // split
    dead = torch.arange(n_split, device=DEV)[None, :] >= live_n[:, None]
    dead = dead[:, None, :, None]
    pm, pl = pm.masked_fill(dead, float("nan")), pl.masked_fill(dead, float("nan"))
    pa = pa.masked_fill(dead[..., None], float("nan"))
    ckw = dict(page_size=ps, kv_split=split, exp_mode="lut")
    got = paged_combine(pm, pl, pa, kvl, **ckw)          # f32 out: the check
    want = paged_combine_reference(pm, pl, pa, kvl, **ckw)
    if not torch.isfinite(got).all():
        fail("paged_combine read a split the split pass never wrote")
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, **F32_TOL):
        fail(f"paged_combine disagrees with its plain version: max|Δ| {err}")
    ms = cuda_ms(lambda: paged_combine(pm, pl, pa, kvl, **ckw,
                                       dtype=torch.bfloat16), flush=flush)
    plain = cuda_ms(lambda: paged_combine_reference(pm, pl, pa, kvl, **ckw),
                    iters=5, flush=flush)
    # bytes and operations the step needs: each live row's partials of the
    # splits its own keys span and its output (the rule of attention_work);
    # the block_q tiling's dead rows of live q-blocks are counted apart
    row_splits = lambda vis: -(-(-(-vis // ps)) // split)  # noqa: E731
    need = decode["hq"] // hkv * sum(row_splits(kv - n + i + 1)
                                     for n, kv in decode["spec"]
                                     for i in range(n))
    live_rows = decode["live"]
    nbytes = (need * hkv * (d + 2) * 4 + live_rows * decode["hq"] * d * 2
              + nb * 4)
    flops = 2.0 * need * hkv * (d + 1)
    n_live = int(torch.clamp(live_n, max=n_split).sum())
    dead_bytes = (n_live * hkv * rows * (d + 2) * 4 + nb * hkv * rows * d * 2
                  + nb * 4 - nbytes)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["float32"] * 1e3
    kernels.append(dict(
        name="paged_combine", route="cuda",
        source="src/repro_torch/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention/kernel.py:132",
        launches=engine_facts["launches"]["bfloat16"]["paged_combine"],
        max_abs_err=err, ms=ms, kernel_ms=ms, plain_ms=plain,
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=None,
        shape=f"decode-step workspace: {nb} q-blocks × {hkv} heads × "
              f"{n_split} splits × {rows} rows × {d}, {n_live} live "
              f"(q-block, split) pairs per head, {live_rows} live rows of "
              f"{nb * rows}, bf16 out",
        dead_row_bytes=dead_bytes))
    log(f"[time] paged_combine: kernel {ms:.4f} ms, plain {plain:.3f} ms, "
        f"bound {max(t_bytes, t_ops):.4f} ms ({nbytes / 1e6:.3f} MB of the "
        f"live rows; the dead rows of block_q {bq} add "
        f"{dead_bytes / 1e6:.2f} MB,"
        f" {dead_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms at the memory rate); "
        f"max|Δ| {err:.3g} against the plain merge in f32 (atol 2e-5, rtol "
        f"1e-4)")

    # LUT exp: standalone on the main path in the sampler, twice a sampling
    # step, over the (lanes, V) f32 shifted scores (values <= 0); beside it
    # the earlier yardstick, every logit of the paged decode call
    lut_entry = lambda x: lut_exp_entry(x, flush)  # noqa: E731

    g = torch.Generator(device=DEV).manual_seed(15)
    scores = torch.randn((ENGINE["lanes"], vocab), generator=g,
                         device=DEV) * 3
    scores = (scores - scores.amax(-1, keepdim=True)).contiguous()
    n = sum(kv_lens) * HQ * 8
    decode_x = (torch.rand(n, device=DEV) * -30.0).contiguous()
    entry = lut_entry(scores)
    decode_entry = dict(lut_entry(decode_x),
                        shape=f"{n} f32 logits (the paged decode call's s − m "
                              f"values)")
    sampled = engine_facts["sampled"]
    kernels.append(dict(
        name="lut_exp", route="cuda", source="src/repro_torch/csrc/lut_exp.cu",
        replaces="src/repro/kernels/lut_exp/kernel.py:95",
        launches=sampled["bf16"]["launches"]["lut_exp"],
        launches_by_path={k: v["lut_exp"] for k, v in
                          engine_facts["paths"].items()},
        on_main_path=True,
        inlined_in="paged_attention and streaming_attention "
                   "(csrc/lut_exp.cuh, every launch)",
        **entry, library="torch.exp (exact exp, not the same function)",
        shape=f"({ENGINE['lanes']}, {vocab}) f32 shifted scores: the "
              f"sampler's two exponentials of a sampling step",
        decode_logits=decode_entry))
    # phase 14's discretisations: falcon-mamba's chunk Ā and decode Ā
    ssm = {}
    for label, shape, hi in SSM_LUT_SHAPES[:2]:
        x = torch.rand(shape, device=DEV, generator=g) * -hi
        ssm[label] = dict(lut_entry(x), shape=f"{shape} f32 Δ ⊗ A values")
        del x
    kernels[-1]["ssm"] = ssm
    # phase 15's sampler: internvl2-1b's (lanes, 151,655) scores
    vlm_scores = torch.randn((ENGINE["lanes"], 151655), generator=g,
                             device=DEV) * 3
    vlm_scores = vlm_scores - vlm_scores.amax(-1, keepdim=True)
    vlm_sampler = dict(lut_entry(vlm_scores),
                       shape="(8, 151655) f32 shifted scores")
    kernels[-1]["internvl2_sampler"] = vlm_sampler
    for label, e in (("sampler shape", entry), ("decode logits", decode_entry),
                     *ssm.items(), ("internvl2 sampler", vlm_sampler)):
        log(f"[time] lut_exp at the {label}: kernel {e['ms']:.4f} ms, device "
            f"alone {e['device_ms']:.4f} ms, host per call {e['host_ms']:.4f} "
            f"ms, plain {e['plain_ms']:.4f} ms, torch.exp "
            f"{e['library_ms']:.4f} ms, bound {e['bound_ms']:.4f} ms "
            f"(medians of 5 interleaved rounds)")
    # #2 at internvl2-1b's GQA 7:1 (phase 15's serve): its decode step at
    # phase 7's prompts' mid-decode lengths, beside SDPA with enable_gqa
    from repro_torch.configs import get_config
    vlm = get_config(VLM_MODEL)
    kernels[0]["families"] = {VLM_MODEL: {"time_decode": time_family_paged(
        vlm, [(1, kv) for kv in kv_lens], "internvl2 decode (GQA 7:1)",
        flush, library=sdpa_gqa_decode)}}
    kernels.append(time_streaming(flush, engine_facts))
    kernels.append(time_int8(flush, engine_facts["int8_bert"]))
    kernels.append(time_quantize(flush, engine_facts["int8_bert"]))
    kernels.append(time_lut_exp_bwd(flush, engine_facts["lut_exp_bwd"]))
    return kernels


def lut_exp_entry(x, flush):
    """Kernel #1 on ``x``: as a caller sees it, device alone and host per
    call, beside its plain version and ``torch.exp``; bound from 8 bytes
    and 12 f32 operations a value."""
    import torch
    from repro_torch.kernels.lut_exp import lut_exp, lut_exp_ref
    got, want = lut_exp(x), lut_exp_ref(x)
    med = interleaved_ms({
        "ms": lambda: cuda_ms(lambda: lut_exp(x), flush=flush),
        "device_ms": lambda: cuda_ms(lambda: lut_exp(x), flush=flush,
                                     spin=True),
        "library_ms": lambda: cuda_ms(lambda: torch.exp(x), flush=flush)})
    t_bytes = 8.0 * x.numel() / HBM_BYTES_PER_S * 1e3
    t_ops = 12.0 * x.numel() / PEAK_FLOPS["float32"] * 1e3
    return dict(
        max_abs_err=float((got - want).abs().max()), ms=med["ms"],
        kernel_ms=med["ms"], device_ms=med["device_ms"],
        host_ms=host_ms(lambda: lut_exp(x)),
        plain_ms=cuda_ms(lambda: lut_exp_ref(x), flush=flush),
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=med["library_ms"])


def time_lut_exp_bwd(flush, checks):
    """#1's backward kernel at ``LUT_BWD_SHAPES`` (f32): as a caller sees
    it, device alone and host per call, beside the plain backward and
    ``torch.mul(g, eˣ)`` — what autograd launches for ``torch.exp``'s
    backward, a yardstick (the exact exponential's derivative, not the
    same function; no PyTorch call computes this one: ``library_ms`` is
    null).  Bound: x and g read once, gx written once (12 bytes a value)
    against 9 f32 operations a value → the kernels-line entry (its
    launches are phase 16's, set by ``main``)."""
    import torch
    from repro_torch.kernels.lut_exp.ops import lut_exp_bwd
    from repro_torch.kernels.lut_exp.ref import lut_exp_bwd_ref
    gen = torch.Generator(device=DEV).manual_seed(47)
    shapes = {}
    for label, shape, hi in LUT_BWD_SHAPES:
        x = torch.rand(shape, device=DEV, generator=gen) * -hi
        g = torch.randn(shape, device=DEV, generator=gen)
        ex = torch.exp(x)
        med = interleaved_ms({
            "ms": lambda: cuda_ms(lambda: lut_exp_bwd(x, g), flush=flush),
            "device_ms": lambda: cuda_ms(lambda: lut_exp_bwd(x, g),
                                         flush=flush, spin=True),
            "yardstick_ms": lambda: cuda_ms(lambda: torch.mul(g, ex),
                                            flush=flush)})
        t_bytes = 12.0 * x.numel() / HBM_BYTES_PER_S * 1e3
        t_ops = 9.0 * x.numel() / PEAK_FLOPS["float32"] * 1e3
        bound = max(t_bytes, t_ops)
        e = dict(ms=med["ms"], device_ms=med["device_ms"],
                 host_ms=host_ms(lambda: lut_exp_bwd(x, g)),
                 plain_ms=cuda_ms(lambda: lut_exp_bwd_ref(x, g), iters=5,
                                  flush=flush),
                 bound_ms=bound,
                 bound_by="bytes" if t_bytes >= t_ops else "operations",
                 bound_share=bound / med["ms"],
                 yardstick_ms=med["yardstick_ms"],
                 mbytes=12.0 * x.numel() / 1e6, shape=f"{shape} f32")
        shapes[label] = e
        log(f"[time] lut_exp_bwd at {label}: kernel {e['ms']:.4f} ms, device "
            f"alone {e['device_ms']:.4f} ms, host per call "
            f"{e['host_ms']:.4f} ms, plain {e['plain_ms']:.4f} ms, g·exp(x) "
            f"(torch.exp's backward, a yardstick) {e['yardstick_ms']:.4f} "
            f"ms, bound {bound:.4f} ms ({e['mbytes']:.1f} MB; the kernel at "
            f"{100 * e['bound_share']:.1f}% of it); {CARD[0]}")
        del x, g, ex
    torch.cuda.empty_cache()
    head = shapes[LUT_BWD_SHAPES[1][0]]       # falcon's chunk Ā, the largest
    return dict(
        name="lut_exp_bwd", route="cuda", source="src/repro_torch/csrc/lut_exp.cu",
        replaces="src/repro/core/lut_exp.py:79 (no Pallas site: jax.grad "
                 "through the jnp LUT of the TPU kernel "
                 "src/repro/kernels/lut_exp/kernel.py:95)",
        launches=0, max_abs_err=max(c["max_abs_err"] for c in checks.values()),
        **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        library_ms=None, yardstick_ms=head["yardstick_ms"],
        yardstick="torch.mul(g, exp(x)): torch.exp's backward (exact exp, "
                  "not the same function)",
        shape=head["shape"], shapes=shapes)


def time_int8(flush, facts):
    """Kernel #4 at the BERT-large projection shapes of an 8 × 512 batch and
    at the reference microbenchmark's shape: the 2-D kernel (int8 in, f32
    out, scales applied) on a K-major w, as the pass calls it — as a caller
    sees it, the device time alone (spin lead) and at each wgmma tile width
    — beside the mma.sync variant on a row-major w (PR 16's design on the
    same call), its plain version, ``torch._int_mm`` alone and plus the same
    scale multiply, each with w row-major and column-major (the library
    yardstick is the faster with the scales; the port never calls it), and
    for context a bf16 ``torch.matmul`` of the same shape.  Launches per
    forward are those counted for each shape in the BERT-large pass.  Bytes:
    x, w, the scales read once and the f32 output written once; operations:
    2·M·N·K at the int8 tensor-core peak."""
    import torch
    from repro_torch.kernels.int8_matmul import int8_matmul_2d, int8_matmul_2d_ref
    from repro_torch.kernels.int8_matmul.ops import TILE_N, default_tile_n
    g = torch.Generator(device=DEV).manual_seed(17)
    timed = {}
    for m, k, n, what in INT8_TIMED:
        xv = torch.randint(-127, 128, (m, k), generator=g, device=DEV,
                           dtype=torch.int8)
        wv = torch.randint(-127, 128, (k, n), generator=g, device=DEV,
                           dtype=torch.int8)
        wk = wv.t().contiguous().t()                  # as quantize stores it
        xs = torch.rand((), generator=g, device=DEV) * 0.01
        ws = torch.rand((1, n), generator=g, device=DEV) * 0.01
        got, want = int8_matmul_2d(xv, wk, xs, ws), int8_matmul_2d_ref(xv, wv, xs, ws)
        err = float((got - want).abs().max())
        kernel = lambda: int8_matmul_2d(xv, wk, xs, ws)  # noqa: E731
        timers = {
            "ms": lambda: cuda_ms(kernel, flush=flush),
            "device_ms": lambda: cuda_ms(kernel, flush=flush, spin=True),
            "mma_sync_ms": lambda: cuda_ms(lambda: int8_matmul_2d(
                xv, wv, xs, ws, variant="mma_sync"), flush=flush),
            "mma_sync_device_ms": lambda: cuda_ms(lambda: int8_matmul_2d(
                xv, wv, xs, ws, variant="mma_sync"), flush=flush, spin=True)}
        for tile in TILE_N:
            timers[f"tile_{tile}"] = lambda tile=tile: cuda_ms(
                lambda: int8_matmul_2d(xv, wk, xs, ws, tile_n=tile),
                flush=flush, spin=True)
        layouts = {"row": wv, "col": wk}
        lib_equal = {}
        for lay, w in layouts.items():
            lib_equal[lay] = bits_equal(torch._int_mm(xv, w).float() * (xs * ws), got)
            timers[f"int_mm_{lay}"] = lambda w=w: cuda_ms(
                lambda: torch._int_mm(xv, w), flush=flush)
            timers[f"lib_{lay}"] = lambda w=w: cuda_ms(
                lambda: torch._int_mm(xv, w).float() * (xs * ws), flush=flush)
        med = interleaved_ms(timers)
        plain = cuda_ms(lambda: int8_matmul_2d_ref(xv, wv, xs, ws), iters=5,
                        flush=flush)
        lib_by = {lay: med[f"lib_{lay}"] for lay in layouts}
        int_mm = {lay: med[f"int_mm_{lay}"] for lay in layouts}
        best = min(lib_by, key=lib_by.get)
        xb, wb = xv.bfloat16(), wv.bfloat16()
        bf16 = cuda_ms(lambda: torch.matmul(xb, wb), flush=flush)
        nbytes = m * k + k * n + 4 * n + 4 + 4 * m * n
        ops = 2.0 * m * n * k
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_FLOPS["int8"] * 1e3
        bound = max(t_bytes, t_ops)
        ms, dev = med["ms"], med["device_ms"]
        label = f"{m}x{k}x{n}"
        timed[label] = dict(
            max_abs_err=err, ms=ms, device_ms=dev, tops=ops / ms / 1e9,
            bound_share=bound / ms, plain_ms=plain, bound_ms=bound,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=lib_by[best], library_w_layout=best,
            library_bit_equal=lib_equal, library_ms_by_w_layout=lib_by,
            int_mm_alone_ms_by_w_layout=int_mm,
            mma_sync_ms=med["mma_sync_ms"],
            mma_sync_device_ms=med["mma_sync_device_ms"],
            wgmma_device_ms_by_tile_n={t: med[f"tile_{t}"] for t in TILE_N},
            tile_n=default_tile_n(m, n), bf16_matmul_ms=bf16,
            launches_per_forward=facts["launches_by_shape"].get(label, 0),
            shape=f"M {m} × K {k} × N {n} ({what}), w K-major")
        tiles = ", ".join(f"{t}: {med[f'tile_{t}']:.4f}" for t in TILE_N)
        log(f"[time] int8_matmul {label} ({what}): wgmma kernel {ms:.4f} ms "
            f"({ops / ms / 1e9:.1f} TOP/s, {bound / ms:.0%} of the bound), "
            f"device alone {dev:.4f} ms (by tile width, device alone: "
            f"{tiles}; default {default_tile_n(m, n)}); mma.sync variant "
            f"{med['mma_sync_ms']:.4f} ms (device alone "
            f"{med['mma_sync_device_ms']:.4f}); plain {plain:.3f} ms; "
            f"_int_mm alone row/col-major w {int_mm['row']:.4f}/"
            f"{int_mm['col']:.4f} ms, +scale {lib_by['row']:.4f}/"
            f"{lib_by['col']:.4f} ms (bit-equal {lib_equal}); launches per "
            f"forward {timed[label]['launches_per_forward']}; bf16 matmul "
            f"{bf16:.4f} ms; bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB, "
            f"{ops / 1e9:.1f} GOP) (medians of 5 interleaved rounds)")
        del xv, wv, wk, xb, wb, got, want, layouts
    first = timed.pop(f"{INT8_TIMED[0][0]}x{INT8_TIMED[0][1]}x{INT8_TIMED[0][2]}")
    return dict(
        name="int8_matmul", route="cuda", source="src/repro_torch/csrc/int8_matmul.cu",
        replaces="src/repro/kernels/int8_matmul/kernel.py:49",
        launches=facts["launches"],
        launches_by_variant=facts["counts"]["by_variant"], **first,
        library="torch._int_mm + the same scale multiply, w in the faster "
                "of row- and column-major",
        bert_int8_projections=facts, **timed)


# (M, K) bf16 activations of the BERT-large pass: the K = 1024 inputs and
# the K = 4096 GELU outputs
QUANT_TIMED = [(4096, 1024), (4096, 4096)]


def time_quantize(flush, facts):
    """The activation quantisation kernel at the pass's two input shapes
    (bf16): as a caller sees it, device alone, host per call, beside the
    plain version (the eager chain it replaces).  Bytes: x read once, the
    int8 values and the scale written once; no PyTorch call computes the
    same function (``torch.quantize_per_tensor_dynamic`` is affine, with a
    zero point), so ``library_ms`` is null."""
    import torch
    from repro_torch.core import quant
    g = torch.Generator(device=DEV).manual_seed(29)
    timed = {}
    for m, k in QUANT_TIMED:
        x = (torch.randn((m, k), generator=g, device=DEV) * 2).bfloat16()
        plain = lambda: quant._quantize(  # noqa: E731
            x, torch.amax(torch.abs(x.to(torch.float32))), 8)
        got, want = quant.quantize_dynamic(x), plain()
        err = float((got.values.float() - want.values.float()).abs().max())
        if err != 0 or not bits_equal(got.scale, want.scale):
            fail(f"quantize_dynamic ({m}, {k}): not bit-equal when timed")
        kernel = lambda: quant.quantize_dynamic(x)  # noqa: E731
        med = interleaved_ms({
            "ms": lambda: cuda_ms(kernel, flush=flush),
            "device_ms": lambda: cuda_ms(kernel, flush=flush, spin=True),
            "plain_ms": lambda: cuda_ms(plain, flush=flush)})
        nbytes = 2 * m * k + m * k + 4
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        timed[f"{m}x{k}"] = dict(
            max_abs_err=err, **med, host_ms=host_ms(kernel), bound_ms=bound,
            bound_by="bytes", library_ms=None, bound_share=bound / med["ms"],
            shape=f"({m}, {k}) bf16 → int8 + one f32 scale")
        log(f"[time] quantize_dynamic ({m}, {k}) bf16: kernel {med['ms']:.4f} "
            f"ms ({bound / med['ms']:.0%} of the bound), device alone "
            f"{med['device_ms']:.4f} ms, host per call "
            f"{timed[f'{m}x{k}']['host_ms']:.4f} ms, plain "
            f"{med['plain_ms']:.4f} ms, bound {bound:.4f} ms "
            f"({nbytes / 1e6:.1f} MB) (medians of 5 interleaved rounds)")
    first = timed.pop(f"{QUANT_TIMED[0][0]}x{QUANT_TIMED[0][1]}")
    return dict(
        name="quantize_dynamic", route="cuda",
        source="src/repro_torch/csrc/quantize.cu",
        replaces="src/repro/core/quant.py:45 (jnp, outside the Pallas kernel)",
        launches=facts["counts"]["quantize_dynamic"], **first,
        library=None, **timed)


def streaming_shapes():
    """(label, (B, Hq, Hkv, Lq, Lkv, D), causal) of kernel #3's main-path
    calls: the BERT-large encodes, the deepseek-7b scoring batch and
    zamba2-1.2b's shared block in its slot prefill of 1,024 tokens."""
    shapes = [(f"l{l}", (b, 16, 16, l, l, 64), False) for b, l in BERT_SHAPES]
    b, l = SCORE_SHAPE
    shapes.append((f"scoring_{b}x{l}", (b, 32, 32, l, l, 128), True))
    shapes.append(("zamba2_shared_prefill_1x1024", ZAMBA2_PREFILL, True))
    return shapes


def time_streaming(flush, facts):
    """Kernel #3 at its main paths' shapes: the BERT-large encodes (bf16, 16
    heads × 64, bidirectional) and the deepseek-7b scoring batch (bf16, 32
    heads × 128, causal): the tensor-core kernel, its plain version, SDPA
    (exact exp, the same mask) and the bound; beside them the same kernel
    with exp_mode "exact" (expf in place of the LUT: what the softmax's
    exponential costs) and the f32 CUDA-core kernel on the same inputs
    widened.  Bytes: q, k, v read once and out written once; operations:
    the QKᵀ and P·V products over the visible keys, at the bf16
    tensor-core peak (the split P·V's second product is the kernel's cost,
    not the function's work)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.streaming_attention import (attention_ref,
                                                         streaming_attention)
    shapes = streaming_shapes()
    timed = {}
    for label, shape, causal in shapes:
        b, hq, _, l, _, d = shape
        q, k, v = sa_inputs(shape, "bfloat16", seed=7)
        q32, k32, v32 = q.float(), k.float(), v.float()
        got = streaming_attention(q, k, v, causal=causal)
        want = attention_ref(q, k, v, causal=causal)
        err = float((got.float() - want.float()).abs().max())
        ms = cuda_ms(lambda: streaming_attention(q, k, v, causal=causal),
                     flush=flush)
        exact = cuda_ms(lambda: streaming_attention(
            q, k, v, causal=causal, exp_mode="exact"), flush=flush)
        f32 = cuda_ms(lambda: streaming_attention(q32, k32, v32, causal=causal),
                      flush=flush)
        plain = cuda_ms(lambda: attention_ref(q, k, v, causal=causal),
                        iters=5, flush=flush)
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal), flush=flush)
        nbytes = 4.0 * q.numel() * q.element_size()
        visible = l * (l + 1) / 2 if causal else l * l
        flops = 4.0 * b * hq * visible * d
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
        timed[label] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=lib, tflops=flops / ms / 1e9, exact_exp_ms=exact,
            f32_cuda_core_ms=f32, f32_cuda_core_tflops=flops / f32 / 1e9,
            shape=f"B {b}, {hq} heads × {d}, l {l}, bf16, "
                  f"{'causal' if causal else 'bidirectional'}")
        log(f"[time] streaming_attention {label} ({timed[label]['shape']}): "
            f"tensor-core kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
            f"exact exp {exact:.4f} ms, f32 CUDA-core kernel {f32:.4f} ms "
            f"({flops / f32 / 1e9:.1f} TFLOP/s), plain {plain:.3f} ms, sdpa "
            f"{lib:.4f} ms, bound {max(t_bytes, t_ops):.4f} ms "
            f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
        del q, k, v, q32, k32, v32, got, want
    timed.update(time_streaming_d256(flush))
    timed.update(time_streaming_calls(GQA_SHAPES, flush, seed=9))
    timed.update(time_streaming_calls(ENCDEC_SHAPES, flush, seed=10))
    first = timed.pop(shapes[0][0])
    return dict(
        name="streaming_attention", route="cuda",
        source="src/repro_torch/csrc/streaming_attention.cu",
        replaces="src/repro/kernels/streaming_attention/kernel.py:130",
        launches=facts["bert"]["launches"],
        launches_per_forward=facts["bert"]["launches"] // len(BERT_SHAPES),
        scoring_launches=facts["scoring"]["bf16"]["launches"],
        **first, library="scaled_dot_product_attention (exact exp, not the "
                         "same function)",
        **timed, tensor_core_build=facts["build"])


def visible_pairs(lq, lkv, *, causal, window=None, kv_len=None, q_offset=0):
    """How many (query row, key) pairs the mask keeps: the work of an
    attention call that skips masked keys."""
    pos = q_offset + np.arange(lq, dtype=np.int64)
    last = np.full(lq, min(lkv, kv_len or lkv) - 1)
    if causal:
        last = np.minimum(last, pos)
    first = np.maximum(0, pos - window + 1) if window else np.zeros(lq, np.int64)
    return int(np.clip(last - first + 1, 0, None).sum())


# Head dim 256 on the main paths: gemma2's scoring batch (a global layer:
# causal, softcap 50) and the slot engine's prefill of the 4,200-token
# prompt on a local layer (the window of 4,096 bites).
D256_SHAPES = (
    ("gemma2 scoring 2x1024 (global layer)", (2, 16, 8, 1024, 1024, 256),
     dict(causal=True, cap=50.0)),
    ("gemma2 slot prefill 1x4200 (local layer)", (1, 16, 8, 4200, 4200, 256),
     dict(causal=True, cap=50.0, window=4096)))


def time_streaming_d256(flush):
    """Kernel #3 at head dim 256 (``D256_SHAPES``): the bf16 tensor-core
    kernel, with exact exp, the f32 CUDA-core kernel, the plain version and
    SDPA.  SDPA is not the same function: its flash path takes head dim 256
    in bf16 only without a mask, so it runs causal without the softcap or
    the window, on k and v widened to the 16 query heads outside the
    timing.  Bytes: q, k, v read once and out written once; operations:
    QKᵀ and P·V over the visible pairs, at the bf16 tensor-core peak."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.streaming_attention import (attention_ref,
                                                         streaming_attention)
    out = {}
    for label, shape, kw in D256_SHAPES:
        b, hq, hkv, lq, lkv, d = shape
        q, k, v = sa_inputs(shape, "bfloat16", seed=8)
        q32, k32, v32 = q.float(), k.float(), v.float()
        got = streaming_attention(q, k, v, **kw)
        want = attention_ref(q, k, v, **kw)
        err = float((got.float() - want.float()).abs().max())
        ms = cuda_ms(lambda: streaming_attention(q, k, v, **kw), flush=flush)
        exact = cuda_ms(lambda: streaming_attention(q, k, v, exp_mode="exact",
                                                    **kw), flush=flush)
        f32 = cuda_ms(lambda: streaming_attention(q32, k32, v32, **kw),
                      iters=5, flush=flush)
        plain = cuda_ms(lambda: attention_ref(q, k, v, **kw), iters=3,
                        flush=flush)
        kx, vx = (t.repeat_interleave(hq // hkv, dim=1) for t in (k, v))
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, kx, vx, is_causal=True), flush=flush)
        nbytes = 2.0 * (2 * b * hq * lq * d + 2 * b * hkv * lkv * d)
        flops = 4.0 * b * hq * d * visible_pairs(
            lq, lkv, causal=kw["causal"], window=kw.get("window"))
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
        out[label] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=lib, tflops=flops / ms / 1e9, exact_exp_ms=exact,
            f32_cuda_core_ms=f32, f32_cuda_core_tflops=flops / f32 / 1e9,
            gflop=flops / 1e9,
            shape=f"B {b}, {hq} × {hkv} heads × {d}, l {lq}, bf16, {kw}")
        log(f"[time] streaming_attention {label} ({out[label]['shape']}): "
            f"tensor-core kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
            f"exact exp {exact:.4f} ms, f32 CUDA-core kernel {f32:.4f} ms, "
            f"plain {plain:.3f} ms, sdpa (causal only, heads widened) "
            f"{lib:.4f} ms, bound {max(t_bytes, t_ops):.4f} ms "
            f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); {CARD[0]}")
        del q, k, v, q32, k32, v32, kx, vx, got, want
        torch.cuda.empty_cache()
    return out


# The MoE family's scoring shapes (2 × 1024, causal): granite-moe's 24 × 8
# heads of 64 (SDPA takes it with ``enable_gqa``) and grok-1's 48 × 8 of 128
# with softcap 30 (no single PyTorch call takes the softcap).
GQA_SHAPES = (
    ("granite scoring 2x1024 (GQA 3:1)", (2, 24, 8, 1024, 1024, 64),
     dict(causal=True)),
    ("grok scoring 2x1024 (GQA 6:1, cap 30)", (2, 48, 8, 1024, 1024, 128),
     dict(causal=True, cap=30.0)))


def sdpa_for(q, k, v, kw):
    """One SDPA call of the same function as kernel #3 with keywords
    ``kw`` (causal, kv_len, window, q_offset; no softcap; the exponential
    exact): GQA through ``enable_gqa``, a kv_len cut, a window or a causal
    block whose query rows do not end at the last key through a boolean
    mask."""
    import torch
    import torch.nn.functional as F
    lq, lkv = q.shape[2], k.shape[2]
    gqa = dict(enable_gqa=True) if q.shape[1] != k.shape[1] else {}
    kv_len, window = kw.get("kv_len"), kw.get("window")
    if kv_len is None and window is None and not kw.get("q_offset") \
            and (not kw.get("causal") or lq == lkv):
        return lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=bool(kw.get("causal")), **gqa)
    rows = kw.get("q_offset", 0) + torch.arange(lq, device=DEV)[:, None]
    keys = torch.arange(lkv, device=DEV)[None, :]
    mask = keys < (kv_len or lkv)
    if kw.get("causal"):
        mask = mask & (keys <= rows)
    if window:
        mask = mask & (rows - keys < window)
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  **gqa)


def time_streaming_calls(shapes, flush, seed):
    """Kernel #3 at ``shapes`` ((label, (B, Hq, Hkv, Lq, Lkv, D), kernel
    keywords)), bf16: the tensor-core kernel, its plain version, SDPA where
    one call computes the same function (``sdpa_for``; none with a
    softcap), and the bound (bytes: q, the kv_len keys and values read
    once, out written once; operations: QKᵀ and P·V over the visible pairs
    at the bf16 peak)."""
    import torch
    from repro_torch.kernels.streaming_attention import (attention_ref,
                                                         streaming_attention)
    out = {}
    for label, shape, kw in shapes:
        b, hq, hkv, lq, lkv, d = shape
        q, k, v = sa_inputs(shape, "bfloat16", seed=seed)
        got = streaming_attention(q, k, v, **kw)
        want = attention_ref(q, k, v, **kw)
        err = float((got.float() - want.float()).abs().max())
        lib_fn = None if kw.get("cap") else sdpa_for(q, k, v, kw)
        lib_err = (None if lib_fn is None else
                   float((lib_fn().float() - want.float()).abs().max()))
        ms = cuda_ms(lambda: streaming_attention(q, k, v, **kw), flush=flush)
        plain = cuda_ms(lambda: attention_ref(q, k, v, **kw), iters=5,
                        flush=flush)
        lib = None if lib_fn is None else cuda_ms(lib_fn, flush=flush)
        keys = kw.get("kv_len") or lkv
        nbytes = 2.0 * (2 * b * hq * lq * d + 2 * b * hkv * keys * d)
        flops = 4.0 * b * hq * d * visible_pairs(
            lq, lkv, causal=kw.get("causal", False), kv_len=kw.get("kv_len"))
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
        out[label] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=lib, library_max_abs_err=lib_err,
            tflops=flops / ms / 1e9, gflop=flops / 1e9,
            shape=f"B {b}, {hq} × {hkv} heads × {d}, Lq {lq}, Lkv {lkv}, "
                  f"bf16, {kw}")
        log(f"[time] streaming_attention {label} ({out[label]['shape']}): "
            f"tensor-core kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
            f"plain {plain:.3f} ms, sdpa "
            + ("none (softcap)" if lib is None else
               f"{lib:.4f} ms (max|Δ| {lib_err:.3g} from the plain version)")
            + f", bound {max(t_bytes, t_ops):.4f} ms ({nbytes / 1e6:.2f} MB, "
            f"{flops / 1e9:.3f} GFLOP); max|Δ| {err:.3g}; {CARD[0]}")
        del q, k, v, got, want
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------- phase 11 --

def family_prompts(cfg, long_len):
    """Phase 7's prompt lengths over ``cfg``'s vocab (seed 0), plus one
    prompt of ``long_len`` tokens where the model has a window."""
    rng, lens = phase7_lens()
    lens = [int(n) for n in lens] + ([long_len] if long_len else [])
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]


def serve_family(cfg, params, kv_quant, prompts, label):
    """Phase 7's captured arm for one family model and pool: a captured
    engine in lockstep with an eager twin (``lockstep_pass``: equal plans,
    logits bit for bit on every step) at the depth of ``step_check_cut``
    (the eager twin's host time grows with depth, and every layer runs the
    same code), then at full depth: a first pass, warm passes until one
    captures nothing new, ``mark_warm()``, a measured pass (``serve_waves``:
    the split pass and the combine each = layers × steps, streams = the
    first pass's), and one more pass whose first 8-lane decode step is
    profiled (kernels per decode step).  → (facts, the captured
    engine)."""
    import torch
    from repro_torch.kernels.autotune import resolve_config
    from repro_torch.serving import EngineCore
    c = cfg.replace(kv_quant=kv_quant)
    cut_cfg, cut_params, _ = step_check_cut(c, params, None)
    make_cut = lambda **kw: EngineCore(  # noqa: E731
        cut_cfg, cut_params, device=DEV, **dict(ENGINE, **kw))
    lce, twin = make_cut(), make_cut(capture=False)
    t0 = time.perf_counter()
    lockstep_pass(lce, twin, prompts, label, {})
    lock_s = time.perf_counter() - t0
    eager = {r.uid - 100: r.tokens for r in twin.finished}
    cut_captured = {r.uid - 100: r.tokens for r in lce.finished}
    del twin, lce
    torch.cuda.empty_cache()
    if any(cut_captured[u] != eager[u] for u in eager):
        fail(f"{label}: a captured stream differs from the eager twin's")
    ce = EngineCore(c, params, device=DEV, **ENGINE)
    want_kc = resolve_config(cfg.name, "cuda")
    if ce.kernel_config != want_kc or ce.kernel_config.source != "tuned":
        fail(f"{label}: resolved {ce.kernel_config.describe()}, not the "
             f"table's {want_kc.describe()}")
    wave = lambda uid0: [[(uid0 + i, p) for i, p in enumerate(prompts)]]  # noqa: E731
    first = serve_waves(ce, wave(100))
    captured = {u - 100: t for u, t in first["streams"].items()}

    def check(run, uid0, what):
        got = {u - uid0: t for u, t in run["streams"].items()}
        if any(got[u] != captured[u] for u in got):
            fail(f"{label}: the {what} pass served other streams than pass 1")

    captures, uid0 = [first["waves"][0]["captures"]], 200
    while captures[-1] and len(captures) < WARM_PASSES:
        w = serve_waves(ce, wave(uid0))
        check(w, uid0, "warm")
        captures.append(w["waves"][0]["captures"])
        uid0 += 100
    ce.obs.mark_warm()
    m = serve_waves(ce, wave(uid0))
    check(m, uid0, "measured")
    retraces = int(ce.obs.registry.value("step_retraces_total"))
    if retraces:
        fail(f"{label}: {retraces} step captures after mark_warm()")
    decode_at = next(i for i, st in enumerate(m["step_log"])
                     if not st["prefill"] and st["decode"] == ENGINE["lanes"])
    tdir = ROOT / "chiprun_out" / "traces"
    counts = read_paged_counts()
    prof = serve_waves(ce, wave(uid0 + 100), profile_at={
        decode_at: str(tdir / f"{label.replace(' ', '_')}_replayed_decode")})
    set_paged_counts(counts)
    window = prof["windows"][decode_at]
    decode_ms = [st["ms"] for st in m["step_log"]
                 if not st["prefill"] and st["decode"] == ENGINE["lanes"]]
    facts = dict(
        lockstep_s=lock_s, lockstep_layers=cut_cfg.num_layers,
        captures_per_pass=captures,
        keys=sorted(ce.graphs.keys), step_retraces_total=retraces,
        steps=m["steps"], launches=m["launches"], generated=m["generated"],
        wall_s=m["wall_s"], tok_s=m["tok_s"], step_ms_p50=m["step_ms_p50"],
        step_ms_p99=m["step_ms_p99"],
        decode_step_ms_p50=float(np.median(decode_ms)),
        peak_gib=m["peak_gib"], kernel_config=ce.kernel_config.describe(),
        streams=captured, decode_window={k: window[k] for k in (
            "launches", "device_ms", "kernel_span_idle_share", "by_group",
            "trace")})
    log(f"[{label}] captured arm: lockstep with the eager twin at "
        f"{cut_cfg.num_layers} of {cfg.num_layers} layers in {lock_s:.1f} s, "
        f"captured = eager on every request (logits bit for bit on every "
        f"step); captures per pass {captures}, keys (T, P) {facts['keys']}; "
        f"after mark_warm(): step_retraces_total {retraces}; measured pass: "
        f"{m['steps']} steps, step ms p50 {m['step_ms_p50']:.2f} p99 "
        f"{m['step_ms_p99']:.2f}, 8-lane decode p50 "
        f"{facts['decode_step_ms_p50']:.2f}; {m['tok_s']:.1f} generated "
        f"tok/s; peak {m['peak_gib']:.2f} GiB; launches {m['launches']} = "
        f"{cfg.num_layers} layers × {m['steps']} steps; replayed decode step "
        f"{window['launches']} kernels, {window['device_ms']:.3f} ms of "
        f"device time; StepOutput.kernel_config {facts['kernel_config']}")
    return facts, ce


def family_sampled(cfg, params, ce, prompts, label):
    """Requests 4–7 sampled (7c's parameters) on the warm captured engine
    ``ce`` (two passes: the first captures the sampler graph, the second
    nothing) and on a fresh eager engine: streams equal bit for bit, two
    LUT-exp launches on every step that samples and none on the others."""
    import torch
    from repro_torch.serving import EngineCore
    traffic, _ = sampled_traffic(prompts)
    wave = lambda uid0: [[(uid0 + i, p, sp) for i, p, sp in traffic]]  # noqa: E731
    first = serve_waves(ce, wave(1000))
    second = serve_waves(ce, wave(1100))
    if second["waves"][0]["captures"] or ce.graphs.sampler_captures != 1:
        fail(f"{label}: the second sampled pass captured "
             f"{second['waves'][0]['captures']} keys; "
             f"{ce.graphs.sampler_captures} sampler captures")
    sampled_steps = sum(st["sampled"] for st in second["step_log"])
    if not sampled_steps or second["launches"]["lut_exp"] != 2 * sampled_steps:
        fail(f"{label}: {second['launches']['lut_exp']} LUT-exp launches over "
             f"{sampled_steps} sampling steps (expected 2 each)")
    ee = EngineCore(cfg, params, device=DEV, capture=False, **ENGINE)
    eager = serve_waves(ee, wave(1000))
    del ee
    torch.cuda.empty_cache()
    norm = lambda r, u0: {u - u0: t for u, t in r["streams"].items()}  # noqa: E731
    if not norm(first, 1000) == norm(second, 1100) == norm(eager, 1000):
        fail(f"{label}: sampled streams differ between the captured passes "
             f"and the eager arm")
    log(f"[{label}] requests 4–7 sampled: captured = eager bit for bit over "
        f"{len(traffic)} requests; {second['steps']} steps, {sampled_steps} "
        f"sampling, LUT-exp launches {second['launches']['lut_exp']} = 2 × "
        f"sampling steps; step ms p50 {second['step_ms_p50']:.2f} p99 "
        f"{second['step_ms_p99']:.2f}; {second['tok_s']:.1f} tok/s")
    return dict(steps=second["steps"], sampled_steps=sampled_steps,
                launches=second["launches"],
                step_ms_p50=second["step_ms_p50"],
                step_ms_p99=second["step_ms_p99"], tok_s=second["tok_s"])


def time_family_paged(cfg, spec, label, flush, library=None, seed=21):
    """Kernel #2 (both launches) at ``cfg``'s heads and kernel keywords on
    the tiled call of stream ``spec`` (bf16 pool, the engine's table row):
    as a caller sees it, device alone and host per call, beside ``library``
    (a function of the stream → one PyTorch call of the same function, or
    None where none exists) and the plain version; bound from the bytes the
    window leaves to read."""
    from repro_torch.kernels.autotune import resolve_config
    from repro_torch.kernels.paged_attention import (
        paged_attention, paged_attention_reference)
    kc = resolve_config(cfg.name, "cuda")
    window = cfg.window if cfg.layer_pattern else None
    kern = dict(scale=cfg.attn_scale or cfg.d_head ** -0.5,
                cap=cfg.attn_softcap, window=window)
    s = make_stream(spec, hq=cfg.num_heads, hkv=cfg.num_kv_heads, d=cfg.d_head,
                    n_pages=ENGINE["num_pages"], seed=seed)
    (a, kw), _, split = tiled_calls(s, kc)
    kw = dict(kw, **kern)
    plain_kw = dict(kw, block_pages=8)
    got = paged_attention(*a, **kw)
    want = paged_attention_reference(*a, **plain_kw)
    err = float((got.float() - want.float()).abs().max())
    kernel = lambda: paged_attention(*a, **kw)  # noqa: E731
    timers = {"ms": lambda: cuda_ms(kernel, flush=flush),
              "device_ms": lambda: cuda_ms(kernel, flush=flush, spin=True)}
    lib = library(s) if library is not None else None
    if lib is not None:
        timers["library_ms"] = lambda: cuda_ms(lib, flush=flush)
        timers["library_device_ms"] = lambda: cuda_ms(lib, flush=flush,
                                                      spin=True)
    med = interleaved_ms(timers)
    plain = cuda_ms(lambda: paged_attention_reference(*a, **plain_kw),
                    iters=5, flush=flush)
    bound, bound_by, nbytes, flops = paged_bound(s, 2, window)
    entry = dict(med, host_ms=host_ms(kernel), plain_ms=plain, bound_ms=bound,
                 bound_by=bound_by, max_abs_err=err, kv_split=split,
                 block_q=kc.block_q, library_ms=med.get("library_ms"),
                 shape=f"{label}: {cfg.num_heads} q × {cfg.num_kv_heads} kv "
                       f"heads of {cfg.d_head}, lanes {spec}, cap "
                       f"{kern['cap']}, window {window}, bf16 pool, block_q "
                       f"{kc.block_q}, {split} pages per split, "
                       f"{s['table'].shape[1]} table slots")
    log(f"[time] paged_attention {entry['shape']}: kernel {med['ms']:.4f} ms, "
        f"device alone {med['device_ms']:.4f}, host per call "
        f"{entry['host_ms']:.4f}; library "
        + (f"{med['library_ms']:.4f} ms (device {med['library_device_ms']:.4f})"
           if lib is not None else "none")
        + f"; plain {plain:.3f} ms; bound {bound:.4f} ms ({bound_by}: "
        f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); max|Δ| {err:.3g}")
    return entry


def sdpa_gqa_decode(s):
    """One SDPA call with ``enable_gqa`` and a length mask over the decode
    lanes' gathered bf16 views: the same function as #2 at exact exp."""
    import torch
    import torch.nn.functional as F
    kv = [kv for _, kv in s["spec"]]
    lmax, n = max(kv), len(kv)
    views = lane_views(s, range(n))
    kg = torch.cat([F.pad(k, (0, 0, 0, lmax - k.shape[2])) for k, _ in views])
    vg = torch.cat([F.pad(v, (0, 0, 0, lmax - v.shape[2])) for _, v in views])
    qd = s["q"][:n].reshape(n, 1, s["hq"], s["d"]).transpose(1, 2).contiguous()
    mask = (torch.arange(lmax, device=DEV)[None, :]
            < torch.tensor(kv, device=DEV)[:, None])[:, None, None]
    return lambda: F.scaled_dot_product_attention(qd, kg, vg, attn_mask=mask,
                                                  enable_gqa=True)


def phase_families():
    """Phase 11: gemma2-9b, gemma3-12b and starcoder2-3b at their published
    widths and full depth, one at a time (each freed before the next),
    seeded weights → per model its facts and #2's timings."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.params import init_params
    from repro_torch.serving import EngineCore
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=DEV)
    flush = lambda: flush_buf.zero_()  # noqa: E731
    out = {}
    for name, long_len in FAMILIES:
        streams = {}
        t_model = time.perf_counter()
        cfg = get_config(name)
        t0 = time.perf_counter()
        params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                             DEV)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in params.values())
        log(f"[weights] {name}: {n_params / 1e9:.2f} B parameters, "
            f"{sum(p.numel() * p.element_size() for p in params.values()) / 1e9:.1f}"
            f" GB {cfg.dtype}, drawn in {time.perf_counter() - t0:.1f} s; "
            f"kinds {cfg.pattern} × {cfg.num_layers // len(cfg.pattern)}")
        prompts = family_prompts(cfg, long_len)
        f = dict(params_b=n_params / 1e9, prompts=[len(p) for p in prompts],
                 parts_s={})
        short = name.split("-")[0]
        pools = (False, True) if short == "gemma2" else (False,)

        def part(what, t0):
            f["parts_s"][what] = time.perf_counter() - t0
            return time.perf_counter()

        for kv_quant in pools:
            tag = f"{short} {'int8' if kv_quant else 'bf16'}"
            t0 = time.perf_counter()
            served, ce = serve_family(cfg, params, kv_quant, prompts, tag)
            t0 = part(f"serve {tag}", t0)
            if not kv_quant:
                # the window bites: a decode lane past it (and the chunk)
                spec = [(1, kv) for kv in (37, 598, 1142, 1700, 2300, 3000,
                                           long_len or 1990)]
                served["step_vs_plain"] = phase_step_vs_plain(
                    cfg, params, ce.kv.pool, f"{tag} step", floor=1e-2,
                    spec=spec + [(CHUNK, 3 * CHUNK)])
                t0 = part(f"step vs plain {tag}", t0)
                if short == "gemma2":
                    served["sampled"] = family_sampled(cfg, params, ce,
                                                       prompts, f"{tag} sampled")
                    part(f"sampled {tag}", t0)
            del ce
            torch.cuda.empty_cache()
            streams[tag] = served.pop("streams")
            f["int8" if kv_quant else "bf16"] = served
        t0 = time.perf_counter()
        mid = [len(p) + MAX_NEW // 2 for p in prompts]
        decode = [(1, kv) for kv in sorted(mid)[-ENGINE["lanes"]:]]
        if short == "gemma2":
            f["time_decode"] = time_family_paged(cfg, decode, "gemma2 decode",
                                                 flush)
            n_chunk = MIXED_CHUNK[0]
            mixed = [(n_chunk, long_len)] + decode[:7]
            f["time_mixed"] = time_family_paged(
                cfg, mixed, "gemma2 mixed step, the window bites the chunk",
                flush)
        elif short == "starcoder2":
            f["time_decode"] = time_family_paged(
                cfg, decode, "starcoder2 decode (GQA 12:1)", flush,
                library=sdpa_gqa_decode)
        part("kernel times", t0)
        t0 = time.perf_counter()
        # scoring on #3: head dim 256 for the gemmas
        f["scoring"] = phase_scoring(cfg, params, f"{short} bf16", floor=1e-2)
        t0 = part("scoring", t0)
        if short == "gemma2":
            # phase 12: the slot engine on the same weights, held to the
            # captured EngineCore streams served above
            make_core = lambda: EngineCore(cfg, params, device=DEV, **ENGINE)  # noqa: E731
            f["slot"] = phase_slot_engine(
                cfg, params, False, prompts, streams[f"{short} bf16"],
                make_core, SLOT_ENGINES[name], f"slot {short} bf16",
                lockstep=False)
            t0 = part("slot engine", t0)
            f["slot_f32"] = slot_engine_f32_cut(cfg, params, prompts, name)
            part("slot engine f32, 2 periods", t0)
        del params
        torch.cuda.empty_cache()
        f["model_s"] = time.perf_counter() - t_model
        log(f"[family {name}] done in {f['model_s']:.1f} s: "
            + json.dumps({k: round(v, 1) for k, v in f["parts_s"].items()}))
        out[name] = f
    return out


# ------------------------------------------------------------- phase 12 --

def slot_engine_f32_cut(cfg, params, prompts, name):
    """Phase 12's ring check where bf16's random-weight logits are too
    loose to hold streams: ``cfg`` at its published width, cut to its first
    two periods (gemma2: 2 local, 2 global layers), the weights widened to
    f32; the slot engine against an f32 ``EngineCore`` on the same prompts
    (``phase_slot_engine``: the long prompt's rings wrapped, streams equal
    save margin-rule forks)."""
    import torch
    from repro_torch.models.lm import layer_keys
    from repro_torch.serving import EngineCore
    cut = cfg.replace(dtype="float32", num_layers=2 * len(cfg.pattern))
    per_layer = set(layer_keys(cfg))
    p32 = {k: (v[:cut.num_layers] if k in per_layer else v).float()
           for k, v in params.items()}
    make = lambda: EngineCore(cut, p32, device=DEV, **ENGINE)  # noqa: E731
    wave = [[(i, p) for i, p in enumerate(prompts)]]
    want = fresh_run(make, lambda e, t: serve_waves(e, wave))(
        frozenset())["streams"]
    facts = phase_slot_engine(cut, p32, False, prompts, want, make,
                              SLOT_ENGINES[name],
                              f"slot {name} f32 {cut.num_layers} layers",
                              lockstep=False)
    del p32
    torch.cuda.empty_cache()
    return facts


def slot_pass(eng, prompts, targets=frozenset(), twin=None, states=False):
    """Serve ``prompts`` (uids 0.., ``MAX_NEW`` new tokens each) through the
    slot engine ``eng``, kernel counts zeroed just before and read just
    after.  ``twin`` (the same engine with ``capture=False``) steps in
    lockstep: after every step its logits, picks and request states must
    equal ``eng``'s bit for bit (its prefills then count too), and with
    ``states`` every cache leaf too (the SSM state, conv and shared K/V).
    ``targets`` {(uid, token index)} → those tokens' logits rows, read
    through ``eng.tap``.  → facts of the pass."""
    import torch
    from repro_torch.kernels.streaming_attention import streaming_attention
    from repro_torch.serving import Request
    rows = {}

    def tap(req, row):
        if (req.uid, len(req.tokens)) in targets:
            rows[req.uid, len(req.tokens)] = row.float().cpu().numpy()

    def state(e):
        return ([None if a is None else (a.uid, list(a.tokens))
                 for a in e.active],
                [(r.uid, list(r.tokens)) for r in e.finished])
    engines = [eng] + ([twin] if twin is not None else [])
    for e in engines:
        e.finished.clear()
        e.prefill_ms.clear()
        e.decode_ms.clear()
        for i, p in enumerate(prompts):
            e.submit(Request(uid=i, prompt=p, max_new=MAX_NEW))
    eng.tap = tap if targets else None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_streaming_counts()
    zero_paged_counts()
    slot_of, steps = {}, 0
    t0 = time.perf_counter()
    while eng.queue or any(a is not None for a in eng.active):
        eng.step()
        if twin is not None:
            twin.step()
            if (not torch.equal(eng.logits, twin.logits)
                    or state(eng) != state(twin)):
                fail(f"slot engine: the captured decode differs from the "
                     f"eager one at step {steps}")
            bad = [k for k in (eng.caches if states else ())
                   if not torch.equal(eng.caches[k], twin.caches[k])]
            if bad:
                fail(f"slot engine: cache leaves {bad} of the captured "
                     f"decode differ from the eager one's at step {steps}")
        for slot, r in enumerate(eng.active):
            if r is not None:
                slot_of.setdefault(r.uid, slot)
        steps += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eng.tap = None
    streams = {r.uid: list(r.tokens) for r in eng.finished}
    if sorted(streams) != list(range(len(prompts))) or any(
            len(t) != MAX_NEW or not all(0 <= x < eng.cfg.vocab_size
                                         for x in t)
            for t in streams.values()):
        fail("slot engine: a request did not produce MAX_NEW in-vocab tokens")
    gen = sum(len(t) for t in streams.values())
    return dict(streams=streams, logits=rows, steps=steps, wall_s=wall,
                generated=gen, tok_s=gen / wall, slot_of=slot_of,
                launches=dict(streaming_attention=streaming_attention.launches,
                              by_variant=dict(
                                  streaming_attention.launches_by_variant),
                              **read_paged_counts()),
                prefill_ms=[(lp, ms) for lp, ms in eng.prefill_ms],
                decode_ms_p50=float(np.percentile(eng.decode_ms, 50)),
                decode_ms_p99=float(np.percentile(eng.decode_ms, 99)),
                decode_steps=len(eng.decode_ms),
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)


def cache_bytes_arithmetic(cfg, slots, max_len, ring: bool) -> int:
    """The contiguous cache's bytes by arithmetic: every layer's K and V
    rows (int8 with f32 row scales under ``kv_quant``), and, with ``ring``,
    a local layer's ring of ``window`` rows with its int32 positions."""
    import torch
    width = torch.finfo(getattr(torch, cfg.dtype)).bits // 8
    item = 1 if cfg.kv_quant else width
    row = cfg.num_kv_heads * cfg.d_head * item + (
        cfg.num_kv_heads * 4 if cfg.kv_quant else 0)
    total = 0
    for kind in cfg.layer_kinds():
        if ring and kind == "local" and cfg.window < max_len:
            total += slots * cfg.window * (
                2 * cfg.num_kv_heads * cfg.d_head * width + 4)
        else:
            total += 2 * slots * max_len * row
    return total


def phase_slot_engine(cfg, params, kv_quant, prompts, want, make_core,
                      sizes, label, *, lockstep=True):
    """Phase 12 for one model and cache: ``ServingEngine`` (``sizes``:
    slots, max_len) at full width and depth serves ``prompts``, 32 new
    each.  With ``lockstep``, a first pass runs the captured engine beside
    an eager twin: captured decode = eager, bit for bit, every step.  The
    measured pass (the captured engine alone; counts zeroed just before):
    kernel #3 launched once per prompt on every layer whose cache is not
    int8 (the tensor-core kernel; an int8 cache attends through the plain
    quantised scan, as in the reference), #2 never; its greedy streams
    equal ``want``
    ({uid: tokens} of the captured ``EngineCore`` on the same prompts)
    save near-tie forks by the margin rule (``hold_by_margin``, both arms
    run again); where local layers keep rings, the longest prompt's ring
    of every local layer holds its last ``window`` positions, position p
    at slot p mod window.  → facts: prefill ms per prompt length, decode
    step p50/p99, tokens/s, peak memory, the cache's bytes beside the
    arithmetic."""
    import torch
    from repro_torch.models.layers import is_ring
    from repro_torch.serving import ServingEngine
    t_phase = time.perf_counter()
    c = cfg.replace(kv_quant=kv_quant)
    make = lambda capture=True: ServingEngine(  # noqa: E731
        c, params, device=DEV, capture=capture, **sizes)
    eng = make()
    measured_bytes = sum(t.numel() * t.element_size()
                         for t in eng.caches.values())
    ring = "ring_pos" in eng.caches
    facts = dict(cache_gb=measured_bytes / 1e9,
                 cache_gb_arithmetic=cache_bytes_arithmetic(
                     c, sizes["slots"], sizes["max_len"], ring) / 1e9,
                 cache_gb_without_ring=cache_bytes_arithmetic(
                     c, sizes["slots"], sizes["max_len"], False) / 1e9,
                 ring_layers=int(eng.caches["ring_pos"].shape[0]) if ring else 0)
    if abs(facts["cache_gb"] - facts["cache_gb_arithmetic"]) > 1e-6:
        fail(f"{label}: the cache holds {facts['cache_gb']} GB, the "
             f"arithmetic says {facts['cache_gb_arithmetic']} GB")
    if lockstep:
        twin = make(capture=False)
        lock = slot_pass(eng, prompts, twin=twin)
        facts["lockstep_steps"] = lock["steps"]
        del twin
        torch.cuda.empty_cache()
    m = slot_pass(eng, prompts)
    if lockstep and m["streams"] != lock["streams"]:
        fail(f"{label}: the measured pass served other streams than the "
             f"lockstep pass")
    # #3 prefills every layer whose cache is not int8 (the int8 cache
    # attends through the plain quantised scan, as the reference's does)
    n_layers = sum(not kv_quant or is_ring(c, kind, sizes["max_len"])
                   for kind in c.layer_kinds())
    n = n_layers * len(prompts)
    la = m["launches"]
    variant = VARIANT[c.dtype]
    if (la["streaming_attention"] != n or la["by_variant"][variant] != n
            or la["paged_attention"] or la["paged_combine"]):
        fail(f"{label}: launches {la}, expected #3 = {n_layers} layers "
             f"× {len(prompts)} prompts on the {variant} kernel and no #2")
    if eng.captures != 1:
        fail(f"{label}: {eng.captures} decode captures, expected 1")
    if ring:
        long_uid = max(range(len(prompts)), key=lambda u: len(prompts[u]))
        end = len(prompts[long_uid]) + MAX_NEW - 1     # last position written
        w = c.window
        pos = torch.arange(end - w, end, dtype=torch.int32, device=DEV)
        expect = torch.empty_like(pos)
        expect[pos % w] = pos
        got = eng.caches["ring_pos"][:, m["slot_of"][long_uid]]
        if len(prompts[long_uid]) <= w or not torch.equal(
                got, expect.expand_as(got)):
            fail(f"{label}: the long prompt's rings do not hold its last "
                 f"{w} positions at their slots")
        facts["ring_check"] = dict(uid=long_uid, prompt=len(prompts[long_uid]),
                                   positions=[end - w, end - 1],
                                   layers=int(got.shape[0]))
    del eng
    torch.cuda.empty_cache()
    wave = [[(i, p) for i, p in enumerate(prompts)]]
    forks = hold_by_margin(
        label, m["streams"], want,
        fresh_run(make, lambda e, t: slot_pass(e, prompts, targets=t)),
        fresh_run(make_core, lambda e, t: serve_waves(e, wave, targets=t)))
    by_len = sorted(m["prefill_ms"])
    facts.update(
        forks=forks, captures=1, steps=m["steps"], launches=la,
        prefill_ms=by_len, decode_ms_p50=m["decode_ms_p50"],
        decode_ms_p99=m["decode_ms_p99"], decode_steps=m["decode_steps"],
        tok_s=m["tok_s"], wall_s=m["wall_s"], peak_gib=m["peak_gib"],
        card=CARD[0], phase_s=time.perf_counter() - t_phase)
    log(f"[{label}] ServingEngine(slots={sizes['slots']}, max_len="
        f"{sizes['max_len']}) over {len(prompts)} prompts × {MAX_NEW} new"
        + (f"; captured = eager bit for bit over {lock['steps']} lockstep "
           f"steps" if lockstep else "")
        + f"; #3 launches {la['streaming_attention']} = {n_layers} layers"
        f" × {len(prompts)} prompts (all {variant}), #2 {la['paged_attention']};"
        f" streams = EngineCore's"
        + (f" save near-tie forks {forks}" if forks else "")
        + (f"; rings of {c.window}: request {facts['ring_check']['uid']} "
           f"({facts['ring_check']['prompt']} tokens) holds positions "
           f"{facts['ring_check']['positions']} on all "
           f"{facts['ring_check']['layers']} local layers" if ring else "")
        + f"; cache {facts['cache_gb']:.3f} GB measured = "
        f"{facts['cache_gb_arithmetic']:.3f} GB arithmetic (without rings "
        f"{facts['cache_gb_without_ring']:.3f} GB); prefill ms by prompt "
        f"length {[(lp, round(ms, 1)) for lp, ms in by_len]}; decode step "
        f"p50 {m['decode_ms_p50']:.2f} p99 {m['decode_ms_p99']:.2f} ms over "
        f"{m['decode_steps']} steps; {m['tok_s']:.1f} generated tok/s; peak "
        f"{m['peak_gib']:.2f} GiB; {facts['phase_s']:.1f} s in all; {CARD[0]}")
    return facts


# ------------------------------------------------------------- phase 13 --

def moe_inputs_spied(fn):
    """Run ``fn()`` with ``lm.moe_apply`` wrapped → (its result, the first
    MoE layer's input it saw: layer 0's of its first step)."""
    import repro_torch.models.lm as lm_mod
    real, seen = lm_mod.moe_apply, []

    def spy(cfg, p, x, **kw):
        if not seen:
            seen.append(x.detach().clone())
        return real(cfg, p, x, **kw)
    lm_mod.moe_apply = spy
    try:
        return fn(), seen[0]
    finally:
        lm_mod.moe_apply = real


def moe_layer_alone(cfg, params, x0, label):
    """Layer 0's experts at full width on ``x0`` (layer 0's input of a
    full-width mixed step) in f32, on the card and on the CPU: equal
    routing (experts, slots, keep flags), gates within 1e-6, ``y`` within
    ``F32_TOL``, ``aux`` within 1e-6 relative; one launch of #1 on the
    card.  Then the bf16 layer timed at that stream and at an 8-row
    decode stream, whole and its router alone (the f32 router product,
    the LUT softmax and the routing rounds)."""
    import torch
    from repro_torch.core.lut_softmax import lut_softmax
    from repro_torch.kernels.lut_exp import lut_exp
    from repro_torch.models import moe
    c32 = cfg.replace(dtype="float32")
    keys = ("router", "up", "gate", "down")
    p32 = {k: params[k][0].float() for k in keys}
    x = x0.float()
    routes, real = [], moe.topk_route
    moe.topk_route = lambda *a: routes.append(real(*a)) or routes[-1]
    try:
        before = lut_exp.launches
        y, aux = moe.moe_apply(c32, p32, x)
        torch.cuda.synchronize()
        launched = lut_exp.launches - before
        t0 = time.perf_counter()
        y_cpu, aux_cpu = moe.moe_apply(c32, {k: v.cpu() for k, v in p32.items()},
                                       x.cpu())
        cpu_s = time.perf_counter() - t0
    finally:
        moe.topk_route = real
    got, want = routes
    same = {f: bool(torch.equal(getattr(got, f).cpu(), getattr(want, f)))
            for f in ("expert", "slot", "keep")}
    gate_err = float((got.gate.cpu() - want.gate).abs().max())
    err = float((y.cpu() - y_cpu).abs().max())
    ok_y = torch.allclose(y.cpu(), y_cpu, **F32_TOL)
    aux_rel = abs(float(aux) - float(aux_cpu)) / abs(float(aux_cpu))
    kept = int(want.keep.sum())
    log(f"[{label}] layer 0's experts alone, f32, {x.shape[1]} rows "
        f"(capacity {moe.moe_capacity(cfg, x.shape[1])}, {kept} of "
        f"{want.keep.numel()} choices kept): card vs CPU routing equal "
        f"{same}, gates max|Δ| {gate_err:.3g}; y max|Δ| {err:.3g} (atol 2e-5, "
        f"rtol 1e-4); aux {float(aux):.7f} vs {float(aux_cpu):.7f} (rel "
        f"{aux_rel:.2g}); #1 launches {launched}; CPU run {cpu_s:.1f} s")
    if not all(same.values()) or gate_err > 1e-6:
        fail(f"{label}: the card's routing differs from the CPU's: {same}, "
             f"gates {gate_err}")
    if not ok_y or aux_rel > 1e-6 or launched != 1:
        fail(f"{label}: y max|Δ| {err}, aux rel {aux_rel}, #1 launches "
             f"{launched}")
    del p32, y_cpu
    # bf16 timings: the layer and its router, each captured as a CUDA graph
    # (as the replayed step runs them), at the mixed and decode streams
    from repro_torch.serving.graphs import CapturedCall
    p = {k: params[k][0] for k in keys}
    times = {}
    for what, xs in (("mixed", x0), ("decode", x0[:, :ENGINE["lanes"]])):
        xs = xs.contiguous()
        tg = xs.shape[1]

        def router(xs=xs, tg=tg):
            logits = torch.matmul(xs.float(), p["router"])
            return moe.topk_route(cfg, lut_softmax(
                logits, exp=moe._router_exp(cfg)), moe.moe_capacity(cfg, tg))
        counts = read_paged_counts()
        layer_g = CapturedCall(
            lambda xs=xs: moe.moe_apply(cfg, p, xs, with_aux=False), DEV)
        router_g = CapturedCall(router, DEV)
        med = interleaved_ms({
            "layer_ms": lambda g=layer_g: cuda_ms(g.replay),
            "router_ms": lambda g=router_g: cuda_ms(g.replay)})
        set_paged_counts(counts)
        del layer_g, router_g
        times[what] = dict(rows=tg, capacity=moe.moe_capacity(cfg, tg), **med)
        log(f"[{label}] bf16 MoE layer at the {what} stream ({tg} rows, "
            f"capacity {times[what]['capacity']}), a replayed graph: "
            f"{med['layer_ms']:.4f} ms, its router (f32 product, LUT softmax, "
            f"{cfg.experts_per_token} rounds) {med['router_ms']:.4f} ms")
    return dict(routing_equal=same, gate_err=gate_err, max_abs_err=err,
                aux=float(aux), aux_cpu=float(aux_cpu), aux_rel=aux_rel,
                kept=kept, choices=want.keep.numel(), cpu_s=cpu_s,
                times=times)


def hold_moe_losses(label, runs, f32, floor):
    """An MoE model's bf16 scoring (``runs``: part → (kernel, plain, plain
    scan)) against its f32 plain run (``f32``, ``phase_scoring``'s held
    parts): the kernel's bf16 value within 3× the farther plain bf16
    schedule's distance from the f32 plain value, ``floor`` at least — as
    close to f32 as bf16 itself gets on this input."""
    held = {}
    for part, (k, p, p2) in runs.items():
        ref = f32[part]["plain"]
        own = max(abs(p - ref), abs(p2 - ref))
        tol, err = max(3.0 * own, floor), abs(k - ref)
        log(f"[{label} {part}] kernel {k:.6f}, plain {p:.6f}, plain scan "
            f"{p2:.6f}; f32 plain {ref:.6f}: kernel |Δ| {err:.3g}, the plain "
            f"bf16 schedules' {own:.3g} (limit {tol:.3g})")
        if not np.isfinite([k, p, p2, ref]).all() or err > tol:
            fail(f"{label} {part}: kernel {k} vs f32 plain {ref} (limit {tol})")
        held[part] = dict(kernel=k, plain=p, plain_scan=p2, f32_plain=ref,
                          limit=tol)
    return held


def phase_moe():
    """Phase 13: granite-moe-3b-a800m at its published widths and full
    depth, then grok-1-314b at its published widths cut to ``MOE_MODELS``'
    depth, one at a time (each freed before the next), seeded weights →
    per model its facts, #2's decode timing and #1's at the router."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.params import init_params
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=DEV)
    flush = lambda: flush_buf.zero_()  # noqa: E731
    out = {}
    for name, cut, pools in MOE_MODELS:
        t_model = time.perf_counter()
        cfg = get_config(name)
        if cut:
            cfg = cfg.replace(num_layers=cut)
        t0 = time.perf_counter()
        params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                             DEV)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in params.values())
        gb = sum(p.numel() * p.element_size() for p in params.values()) / 1e9
        log(f"[weights] {name}: {n_params / 1e9:.2f} B parameters, {gb:.1f} "
            f"GB, {cfg.num_layers} layers"
            + (f" (cut from {get_config(name).num_layers})" if cut else "")
            + f", {cfg.num_experts} experts top-{cfg.experts_per_token} of "
            f"width {cfg.d_ff}; drawn in {time.perf_counter() - t0:.1f} s")
        short = name.split("-")[0]
        prompts = family_prompts(cfg, None)
        f = dict(params_b=n_params / 1e9, gb=gb, layers=cfg.num_layers,
                 prompts=[len(p) for p in prompts], parts_s={})

        def part(what, t0):
            f["parts_s"][what] = time.perf_counter() - t0
            return time.perf_counter()

        for kv_quant in pools:
            tag = f"{short} {'int8' if kv_quant else 'bf16'}"
            t0 = time.perf_counter()
            served, ce = serve_family(cfg, params, kv_quant, prompts, tag)
            router = served["launches"]["lut_exp"]
            if router != cfg.num_layers * served["steps"]:
                fail(f"{tag}: #1 launched {router} times in the measured "
                     f"pass, expected layers × steps = {cfg.num_layers} × "
                     f"{served['steps']}")
            t0 = part(f"serve {tag}", t0)
            if not kv_quant and short == "granite":
                step, x0 = moe_inputs_spied(lambda: phase_step_vs_plain(
                    cfg, params, ce.kv.pool, f"{tag} step", floor=1e-2))
                served["step_vs_plain"] = step
                t0 = part(f"step vs plain {tag}", t0)
                served["layer_alone"] = moe_layer_alone(cfg, params, x0,
                                                        f"{tag} MoE layer")
                part(f"MoE layer alone {tag}", t0)
            del ce
            torch.cuda.empty_cache()
            served.pop("streams")
            f["int8" if kv_quant else "bf16"] = served
        t0 = time.perf_counter()
        mid = [len(p) + MAX_NEW // 2 for p in prompts]
        decode = [(1, kv) for kv in sorted(mid)[-ENGINE["lanes"]:]]
        gqa = cfg.num_heads // cfg.num_kv_heads
        f["time_decode"] = time_family_paged(
            cfg, decode, f"{short} decode (GQA {gqa}:1"
            + (f", cap {cfg.attn_softcap:g})" if cfg.attn_softcap else ")"),
            flush, library=None if cfg.attn_softcap else sdpa_gqa_decode)
        g = torch.Generator(device=DEV).manual_seed(16)
        f["time_router_exp"] = {}
        for rows in (384, ENGINE["lanes"]):
            z = torch.randn((1, rows, cfg.num_experts), generator=g,
                            device=DEV) * 3
            z = (z - z.amax(-1, keepdim=True)).contiguous()
            e = lut_exp_entry(z, flush)
            e["shape"] = (f"(1, {rows}, {cfg.num_experts}) f32 router logits "
                          f"less their maximum")
            f["time_router_exp"][rows] = e
            log(f"[time] lut_exp at {short}'s router, {e['shape']}: kernel "
                f"{e['ms']:.4f} ms, device alone {e['device_ms']:.4f}, host "
                f"per call {e['host_ms']:.4f}, plain {e['plain_ms']:.4f}, "
                f"torch.exp {e['library_ms']:.4f}, bound {e['bound_ms']:.5f} "
                f"ms; max|Δ| {e['max_abs_err']:.3g}")
        t0 = part("kernel times", t0)
        f["scoring"] = phase_scoring(cfg, params, f"{short} bf16", floor=1e-2)
        t0 = part("scoring", t0)
        # f32: the weights widened in place (the bf16 dict is consumed)
        for k in list(params):
            params[k] = params.pop(k).float()
        f["scoring_f32"] = phase_scoring(cfg.replace(dtype="float32"), params,
                                         f"{short} f32", floor=1e-3)
        f["scoring"]["held_to_f32"] = hold_moe_losses(
            f"scoring {short} bf16", f["scoring"].pop("losses"),
            f["scoring_f32"], floor=1e-3)
        part("f32 scoring", t0)
        del params
        torch.cuda.empty_cache()
        f["model_s"] = time.perf_counter() - t_model
        log(f"[moe {name}] done in {f['model_s']:.1f} s: "
            + json.dumps({k: round(v, 1) for k, v in f["parts_s"].items()}))
        out[name] = f
    return out


# ------------------------------------------------------------- phase 14 --

def ssm_exp_launches(cfg, prompt_lens, decode_steps) -> int:
    """Kernel #1's launches in a slot pass of an SSM model by formula: per
    layer, one (Mamba-1's Ā) or four (Mamba-2's decays) per chunk of every
    prompt's prefill, and one per decode step."""
    per_chunk = 4 if cfg.ssm_variant == "mamba2" else 1
    chunks = sum(-(-n // cfg.ssm_chunk) for n in prompt_lens)
    return cfg.num_layers * (per_chunk * chunks + decode_steps)


def ssm_cache_bytes(cfg, slots, max_len) -> int:
    """The SSM cache's bytes by arithmetic: every layer's conv state (the
    last K-1 inputs of its conv channels, model dtype) and scan state
    (Mamba-1 d_inner × n, Mamba-2 H × N × P, f32), and the hybrid's shared
    block's K and V per period."""
    import torch
    from repro_torch.models.lm import period_layout
    width = torch.finfo(getattr(torch, cfg.dtype)).bits // 8
    if cfg.ssm_variant == "mamba2":
        channels = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
        state = cfg.d_inner * cfg.ssm_state              # H × N × P
    else:
        channels, state = cfg.d_inner, cfg.d_inner * cfg.ssm_state
    total = cfg.num_layers * slots * ((cfg.ssm_conv - 1) * channels * width
                                      + state * 4)
    if cfg.family == "hybrid":
        nper = period_layout(cfg)[1]
        total += 2 * nper * slots * max_len * cfg.num_kv_heads * cfg.d_head * width
    return total


def ssm_layer_alone(cfg, params, label):
    """Layer 0's mixer at full width in f32, on the card and on the CPU:
    ``SSM_LAYER_ROWS`` rows (three chunks, the last partial) from a
    non-zero carried state (conv and scan state drawn from a seed), then
    four decode steps; ``y``, the scan state (``h`` / ``S``) and ``conv``
    after each call, each within ``SSM_REL_TOL`` of its own scale (the
    largest magnitude of the CPU's value); #1 launched once (Mamba-1) or
    four times (Mamba-2) per chunk and once per decode step."""
    import torch
    from repro_torch.kernels.lut_exp import lut_exp
    from repro_torch.models import mamba, mamba2
    from repro_torch.models.lm import layer_keys
    c32 = cfg.replace(dtype="float32")
    two = cfg.ssm_variant == "mamba2"
    apply, init, state = ((mamba2.mamba2_apply, mamba2.mamba2_cache_init, "S")
                          if two else
                          (mamba.mamba_apply, mamba.mamba_cache_init, "h"))
    p_cpu = {k: params[k][0].float().cpu() for k in layer_keys(cfg)}
    p_dev = {k: v.to(DEV) for k, v in p_cpu.items()}
    g = torch.Generator().manual_seed(23)
    c_cpu = {k: torch.randn(v.shape[1:], generator=g) * 0.5
             for k, v in init(c32, 1).items()}
    c_dev = {k: v.to(DEV) for k, v in c_cpu.items()}
    worst, t_cpu = {}, 0.0
    before = lut_exp.launches
    for step, rows in enumerate((SSM_LAYER_ROWS, 1, 1, 1, 1)):
        x = torch.randn((1, rows, cfg.d_model), generator=g)
        y_dev = apply(c32, p_dev, x.to(DEV), cache=c_dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y_cpu = apply(c32, p_cpu, x, cache=c_cpu)
        t_cpu += time.perf_counter() - t0
        for what, got, want in (("y", y_dev, y_cpu),
                                (state, c_dev[state], c_cpu[state]),
                                ("conv", c_dev["conv"], c_cpu["conv"])):
            scale = float(want.abs().max())
            err = float((got.cpu() - want).abs().max())
            worst[what] = max(worst.get(what, 0.0), err / scale)
            if not torch.isfinite(got).all() or err > SSM_REL_TOL * scale:
                fail(f"{label}: layer 0's {what} after call {step} ({rows} "
                     f"rows): card vs CPU max|Δ| {err:.3g} above "
                     f"{SSM_REL_TOL} × its scale {scale:.3g}")
    launched = lut_exp.launches - before
    want_launches = ((4 if two else 1) * -(-SSM_LAYER_ROWS // cfg.ssm_chunk)
                     + 4)
    log(f"[{label}] layer 0's mixer alone at full width, f32: "
        f"{SSM_LAYER_ROWS} rows from a carried state, then 4 decode steps: "
        f"card vs CPU max|Δ| / scale "
        + json.dumps({k: float(f"{v:.3g}") for k, v in worst.items()})
        + f" (limit {SSM_REL_TOL}); #1 launches {launched} = "
        f"{want_launches}; CPU {t_cpu:.1f} s")
    if launched != want_launches:
        fail(f"{label}: layer 0's mixer launched #1 {launched} times, "
             f"expected {want_launches}")
    del p_dev, c_dev
    torch.cuda.empty_cache()
    return dict(rows=SSM_LAYER_ROWS, decode_steps=4, rel_err=worst,
                limit=SSM_REL_TOL, lut_launches=launched, cpu_s=t_cpu)


def profile_slot_decode(eng, label):
    """One replayed decode step of the slot engine ``eng`` (its captured
    graph, the slots as the last step left them) under ``torch.profiler``
    → ``read_window``'s summary: kernels and device time by group."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    tdir = ROOT / "chiprun_out" / "traces"
    tdir.mkdir(parents=True, exist_ok=True)
    path = str(tdir / f"{label.replace(' ', '_')}_replayed_decode.json")
    counts = read_paged_counts()
    eng._graph.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng._graph.replay()
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    set_paged_counts(counts)
    return read_window(path, f"{label} replayed decode step")


def serve_ssm(cfg, params, prompts, label):
    """Phase 14's serving for one SSM model: ``ServingEngine`` (``SSM_SLOTS``)
    over ``prompts``, 32 new each.  A lockstep pass of the captured decode
    beside an eager twin (logits, picks, request states and every cache
    leaf bit for bit on every step), then the measured pass (counts zeroed
    just before): #1 launched by ``ssm_exp_launches``' formula, #3 once
    per period per prompt (the hybrid's shared block; none for Mamba-1),
    #2 never, the streams the lockstep pass's; the cache's bytes equal
    the arithmetic; one replayed decode step profiled."""
    import torch
    from repro_torch.models.lm import period_layout
    from repro_torch.serving import ServingEngine
    make = lambda capture=True: ServingEngine(  # noqa: E731
        cfg, params, device=DEV, capture=capture, **SSM_SLOTS)
    eng = make()
    measured = sum(t.numel() * t.element_size() for t in eng.caches.values())
    want_bytes = ssm_cache_bytes(cfg, SSM_SLOTS["slots"], SSM_SLOTS["max_len"])
    if measured != want_bytes:
        fail(f"{label}: the cache holds {measured} bytes, the arithmetic "
             f"says {want_bytes}")
    t0 = time.perf_counter()
    twin = make(capture=False)
    lock = slot_pass(eng, prompts, twin=twin, states=True)
    lock_s = time.perf_counter() - t0
    del twin
    torch.cuda.empty_cache()
    m = slot_pass(eng, prompts)
    if m["streams"] != lock["streams"]:
        fail(f"{label}: the measured pass served other streams than the "
             f"lockstep pass")
    la = m["launches"]
    lens = [len(p) for p in prompts]
    want_lut = ssm_exp_launches(cfg, lens, m["decode_steps"])
    nper = period_layout(cfg)[1] if cfg.family == "hybrid" else 0
    want_sa = nper * len(prompts)
    variant = VARIANT[cfg.dtype]
    if (la["lut_exp"] != want_lut or la["streaming_attention"] != want_sa
            or la["by_variant"][variant] != want_sa
            or la["paged_attention"] or la["paged_combine"]):
        fail(f"{label}: launches {la}, expected #1 = {want_lut} (formula), "
             f"#3 = {nper} periods × {len(prompts)} prompts on the {variant} "
             f"kernel, no #2")
    if eng.captures != 1:
        fail(f"{label}: {eng.captures} decode captures, expected 1")
    window = profile_slot_decode(eng, label)
    by_len = sorted(m["prefill_ms"])
    facts = dict(
        lockstep_steps=lock["steps"], lockstep_s=lock_s, steps=m["steps"],
        launches=la, lut_exp_formula=want_lut, captures=eng.captures,
        cache_gb=measured / 1e9, prefill_ms=by_len,
        decode_ms_p50=m["decode_ms_p50"], decode_ms_p99=m["decode_ms_p99"],
        decode_steps=m["decode_steps"], tok_s=m["tok_s"], wall_s=m["wall_s"],
        peak_gib=m["peak_gib"], generated=m["generated"],
        decode_window={k: window[k] for k in (
            "launches", "device_ms", "kernel_span_idle_share", "by_group",
            "top", "trace")}, card=CARD[0])
    log(f"[{label}] ServingEngine(slots={SSM_SLOTS['slots']}, max_len="
        f"{SSM_SLOTS['max_len']}) over {len(prompts)} prompts × {MAX_NEW} new: "
        f"captured = eager bit for bit (logits, picks, every cache leaf) over "
        f"{lock['steps']} lockstep steps ({lock_s:.1f} s); measured pass: #1 "
        f"launches {la['lut_exp']} = {want_lut} (formula), #3 "
        f"{la['streaming_attention']} = {nper} periods × {len(prompts)} "
        f"prompts, #2 {la['paged_attention']}; cache {measured / 1e9:.4f} GB "
        f"= the arithmetic; prefill ms by prompt length "
        f"{[(lp, round(ms, 1)) for lp, ms in by_len]}; decode step p50 "
        f"{m['decode_ms_p50']:.2f} p99 {m['decode_ms_p99']:.2f} ms over "
        f"{m['decode_steps']} steps; {m['tok_s']:.1f} generated tok/s; peak "
        f"{m['peak_gib']:.2f} GiB; {CARD[0]}")
    del eng
    torch.cuda.empty_cache()
    return facts


def phase_ssm():
    """Phase 14: falcon-mamba-7b (Mamba-1) and zamba2-1.2b (Mamba-2 and its
    shared attention block) at their published widths and full depth, one
    at a time (each freed before the next), seeded bf16 weights: the page
    pool refuses each (``UnsupportedCacheLayout("ssm_state")``), the slot
    engine serves phase 7's prompts (``serve_ssm``), and layer 0's mixer
    alone holds the CPU in f32 (``ssm_layer_alone``) → facts per model."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.params import init_params
    from repro_torch.serving import EngineCore, UnsupportedCacheLayout
    out = {}
    for name in SSM_MODELS:
        t_model = time.perf_counter()
        cfg = get_config(name)
        t0 = time.perf_counter()
        params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                             DEV)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in params.values())
        gb = sum(p.numel() * p.element_size() for p in params.values()) / 1e9
        log(f"[weights] {name}: {n_params / 1e9:.2f} B parameters, {gb:.1f} "
            f"GB {cfg.dtype}, {cfg.num_layers} {cfg.ssm_variant} layers"
            + (f" + a shared attention block before each of "
               f"{cfg.num_layers // cfg.hybrid_period} periods of "
               f"{cfg.hybrid_period}" if cfg.family == "hybrid" else "")
            + f"; drawn in {time.perf_counter() - t0:.1f} s")
        short = name.split("-")[0]
        f = dict(params_b=n_params / 1e9, gb=gb, layers=cfg.num_layers,
                 parts_s={})
        try:
            EngineCore(cfg, params, device=DEV, **ENGINE)
        except UnsupportedCacheLayout as e:
            if e.layout != "ssm_state":
                fail(f"{name}: EngineCore refused with layout {e.layout!r}")
            f["engine_core_refusal"] = str(e)
            log(f"[{short}] EngineCore refuses: {e}")
        else:
            fail(f"{name}: EngineCore accepted an SSM model")
        prompts = family_prompts(cfg, None)
        f["prompts"] = [len(p) for p in prompts]
        t0 = time.perf_counter()
        f["slot"] = serve_ssm(cfg, params, prompts, f"slot {short} bf16")
        f["parts_s"]["serve"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        f["layer_alone"] = ssm_layer_alone(cfg, params, f"{short} layer 0")
        f["parts_s"]["layer alone"] = time.perf_counter() - t0
        del params
        torch.cuda.empty_cache()
        f["model_s"] = time.perf_counter() - t_model
        log(f"[ssm {name}] done in {f['model_s']:.1f} s: "
            + json.dumps({k: round(v, 1) for k, v in f["parts_s"].items()}))
        out[name] = f
    return out


# ------------------------------------------------------------- phase 15 --

def draw_weights(name):
    """``name``'s config and seeded bf16 weights on the card (seed 0)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.params import init_params
    cfg = get_config(name)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0), DEV)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in params.values())
    gb = sum(p.numel() * p.element_size() for p in params.values()) / 1e9
    log(f"[weights] {name}: {n / 1e9:.3f} B parameters, {gb:.2f} GB "
        f"{cfg.dtype}, drawn in {time.perf_counter() - t0:.1f} s")
    return cfg, params, dict(params_b=n / 1e9, gb=gb)


def greedy_generate(step, first_logits, n):
    """``n`` greedy decode steps from ``first_logits``: ``step(t, tokens)``
    → the next logits → (tokens (B, n + 1) on the host, per-step host ms,
    each ending in the picks' read)."""
    import torch
    from repro_torch.serving.sampling import greedy_rows
    tok = greedy_rows(first_logits)
    out, ms = [tok.cpu()], []
    for t in range(n):
        s0 = time.perf_counter()
        tok = greedy_rows(step(t, tok))
        out.append(tok.cpu())
        ms.append((time.perf_counter() - s0) * 1e3)
    return torch.stack(out, 1).numpy(), ms


def phase_vlm():
    """Phase 15 (a): internvl2-1b at its published widths and full depth.
    ``EngineCore`` serves phase 7's prompts as text (``serve_family``: a
    captured engine in lockstep with an eager twin, ``mark_warm()`` and 0
    captures after it, #2's split pass and combine each = layers × steps;
    requests 4–7 sampled, 2 LUT-exp launches a sampling step).  Then the
    multimodal entry: ``Model.prefill`` of VLM_BATCH requests, each a
    seeded (256, 896) prefix and VLM_PROMPT tokens — #3 once per layer —
    held against ``lm_apply`` with the prefix on the plain attention by
    PR 11's margin rule, and GEN_NEW greedy ``decode_step``s at Lp + L + t
    (no #3: a decode row is ``naive_decode``); then the prefill again in
    f32, held the same way."""
    import torch
    from repro_torch.kernels.streaming_attention import streaming_attention
    from repro_torch.models.api import build_model
    from repro_torch.models.lm import lm_apply
    cfg, params, f = draw_weights(VLM_MODEL)
    f["parts_s"] = {}
    t0 = time.perf_counter()
    prompts = family_prompts(cfg, None)
    served, ce = serve_family(cfg, params, False, prompts, "internvl2 bf16")
    served["sampled"] = family_sampled(cfg, params, ce, prompts,
                                       "internvl2 sampled")
    served.pop("streams")
    del ce
    torch.cuda.empty_cache()
    f["bf16"] = served
    f["parts_s"]["serve"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    m = build_model(cfg)
    lp, b, lt = cfg.frontend_len, VLM_BATCH, VLM_PROMPT
    g = torch.Generator(device=DEV).manual_seed(23)
    prefix = (torch.randn((b, lp, cfg.d_model), generator=g, device=DEV)
              * 0.05).to(torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab_size, (b, lt), generator=g,
                           device=DEV, dtype=torch.int32)
    batch = {"tokens": tokens, "prefix_embed": prefix}
    max_len = lp + lt + GEN_NEW
    m.prefill(params, batch, m.init_cache(b, max_len, device=DEV))  # warm
    caches = m.init_cache(b, max_len, device=DEV)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_streaming_counts()
    s0 = time.perf_counter()
    logits, _ = m.prefill(params, batch, caches)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - s0) * 1e3
    expect_variant("internvl2 multimodal prefill", VARIANT[cfg.dtype],
                   cfg.num_layers)
    launches = streaming_attention.launches
    plain = [lm_apply(cfg.replace(attn_backend=be), params, tokens,
                      prefix_embed=prefix, logits_rows=1)[:, -1]
             for be in ("naive", "jnp")]
    held = hold_logits("internvl2 multimodal prefill", logits, *plain,
                       floor=1e-2)
    reset_streaming_counts()
    toks, ms = greedy_generate(
        lambda t, tok: m.decode_step(params, tok, caches, lp + lt + t)[0],
        logits, GEN_NEW)
    if streaming_attention.launches:
        fail(f"internvl2 decode: #3 launched {streaming_attention.launches} "
             f"times in {GEN_NEW} decode steps (a decode row is "
             f"naive_decode)")
    if not ((0 <= toks) & (toks < cfg.vocab_size)).all():
        fail("internvl2 decode: a token outside the vocab")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    f["multimodal"] = dict(
        batch=b, prefix=lp, prompt=lt, new=GEN_NEW, prefill_ms=prefill_ms,
        launches=launches, decode_ms_p50=float(np.median(ms)),
        decode_ms_p99=float(np.percentile(ms, 99)),
        tok_s=b * GEN_NEW / ((prefill_ms + sum(ms)) / 1e3), peak_gib=peak,
        held=held, card=CARD[0])
    log(f"[internvl2 multimodal] prefill of {b} × ({lp} patches + {lt} "
        f"tokens): {prefill_ms:.2f} ms, #3 {launches} launches (1 per "
        f"layer); {GEN_NEW} greedy decode steps at Lp + L + t: p50 "
        f"{f['multimodal']['decode_ms_p50']:.2f} p99 "
        f"{f['multimodal']['decode_ms_p99']:.2f} ms, #3 0; "
        f"{f['multimodal']['tok_s']:.1f} generated tok/s; peak {peak:.2f} "
        f"GiB; {CARD[0]}")
    # the same prefill in f32 (the weights widened, the bf16 dict
    # consumed): the CUDA-core kernel against the plain attention, where
    # two plain schedules land within f32 rounding of each other
    del caches
    c32 = cfg.replace(dtype="float32")
    for k in list(params):
        params[k] = params.pop(k).float()
    batch32 = {"tokens": tokens, "prefix_embed": prefix.float()}
    m32 = build_model(c32)
    reset_streaming_counts()
    logits32, _ = m32.prefill(params, batch32,
                              m32.init_cache(b, max_len, device=DEV))
    expect_variant("internvl2 multimodal prefill f32", VARIANT[c32.dtype],
                   cfg.num_layers)
    plain = [lm_apply(c32.replace(attn_backend=be), params, tokens,
                      prefix_embed=prefix.float(), logits_rows=1)[:, -1]
             for be in ("naive", "jnp")]
    f["multimodal"]["held_f32"] = hold_logits(
        "internvl2 multimodal prefill f32", logits32, *plain, floor=1e-3)
    f["parts_s"]["multimodal"] = time.perf_counter() - t0
    del params, m
    torch.cuda.empty_cache()
    return f


def phase_encdec():
    """Phase 15 (b): seamless-m4t-large-v2 at its published widths and full
    depth (24 + 24 layers).  ``EngineCore`` refuses it
    (``UnsupportedCacheLayout("no_paged_step")``) and so does the slot
    engine (``NotImplementedError``); the Model API generates: ``prefill``
    of ENCDEC_BATCH requests, each (256, 1024) seeded frames and
    ENCDEC_PROMPT tokens — #3 72 times (24 encoder, 24 decoder
    self-attention, 24 cross-attention), the cross K/V projected once —,
    then GEN_NEW greedy ``decode_step``s (no #3), the prefill's logits held
    against ``decode_trunk`` on the plain attention by the margin rule; the
    scoring loss on ENCDEC_SCORE tokens behind 256 frames (#3 72 times)
    against the plain attention."""
    import torch
    from repro_torch.kernels.streaming_attention import streaming_attention
    from repro_torch.models import encdec as ED
    from repro_torch.models.api import build_model
    from repro_torch.serving import (EngineCore, ServingEngine,
                                     UnsupportedCacheLayout)
    cfg, params, f = draw_weights(ENCDEC_MODEL)
    f["parts_s"] = {}
    t0 = time.perf_counter()
    try:
        EngineCore(cfg, params, device=DEV, **ENGINE)
    except UnsupportedCacheLayout as e:
        if e.layout != "no_paged_step":
            fail(f"seamless: EngineCore refused with layout {e.layout!r}")
        f["engine_core_refusal"] = str(e)
    else:
        fail("seamless: EngineCore accepted an encoder-decoder")
    try:
        ServingEngine(cfg, params, device=DEV, slots=ENCDEC_BATCH,
                      max_len=ENCDEC_PROMPT + GEN_NEW)
    except NotImplementedError as e:
        f["slot_engine_refusal"] = str(e)
    else:
        fail("seamless: the slot engine accepted an encoder-decoder")
    log(f"[seamless] EngineCore refuses: {f['engine_core_refusal']}")
    log(f"[seamless] ServingEngine refuses: {f['slot_engine_refusal']}")

    m = build_model(cfg)
    b, lt, per = ENCDEC_BATCH, ENCDEC_PROMPT, 3 * cfg.dec_layers
    g = torch.Generator(device=DEV).manual_seed(29)
    frames = (torch.randn((b, cfg.frontend_len, cfg.d_model), generator=g,
                          device=DEV) * 0.05).to(torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab_size, (b, lt), generator=g,
                           device=DEV, dtype=torch.int32)
    batch = {"frames": frames, "tokens": tokens}
    max_len = lt + GEN_NEW
    m.prefill(params, batch, m.init_cache(b, max_len, device=DEV))  # warm
    encode_ms = []
    for _ in range(3):
        s0 = time.perf_counter()
        ED.encode(cfg, params, frames)
        torch.cuda.synchronize()
        encode_ms.append((time.perf_counter() - s0) * 1e3)
    caches = m.init_cache(b, max_len, device=DEV)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_streaming_counts()
    s0 = time.perf_counter()
    logits, state = m.prefill(params, batch, caches)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - s0) * 1e3
    expect_variant("seamless prefill", VARIANT[cfg.dtype],
                   cfg.enc_layers + 2 * cfg.dec_layers)
    launches = streaming_attention.launches
    cross = {k: v.clone() for k, v in state["cross"].items()}

    def plain_logits(be):
        c = cfg.replace(attn_backend=be)
        ckv = ED.cross_kvs_init(c, params, ED.encode(c, params, frames))
        return ED.decode_trunk(c, params, tokens, ckv, logits_rows=1)[:, -1]
    held = hold_logits("seamless prefill", logits,
                       *(plain_logits(be) for be in ("naive", "jnp")),
                       floor=1e-2)
    reset_streaming_counts()
    steps = []

    def step(t, tok):
        lg, st = m.decode_step(params, tok, state, lt + t)
        steps.append(st["cross"] is state["cross"])
        return lg
    toks, ms = greedy_generate(step, logits, GEN_NEW)
    if streaming_attention.launches:
        fail(f"seamless decode: #3 launched {streaming_attention.launches} "
             f"times in {GEN_NEW} decode steps")
    if not all(steps) or any(not torch.equal(cross[k], state["cross"][k])
                             for k in cross):
        fail("seamless decode: a step did not carry the cross K/V unchanged")
    if not ((0 <= toks) & (toks < cfg.vocab_size)).all():
        fail("seamless decode: a token outside the vocab")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    f["generate"] = dict(
        batch=b, frames=cfg.frontend_len, prompt=lt, new=GEN_NEW,
        encode_ms=float(np.median(encode_ms)), prefill_ms=prefill_ms,
        launches_per_prefill=launches, launches_per_decode_step=0,
        decode_ms_p50=float(np.median(ms)),
        decode_ms_p99=float(np.percentile(ms, 99)),
        tok_s=b * GEN_NEW / ((prefill_ms + sum(ms)) / 1e3), peak_gib=peak,
        held=held, card=CARD[0])
    gen = f["generate"]
    log(f"[seamless generate] {b} requests × ({cfg.frontend_len} frames + "
        f"{lt} tokens): encode {gen['encode_ms']:.2f} ms, prefill "
        f"{prefill_ms:.2f} ms with #3 {launches} launches = {per} "
        f"({cfg.enc_layers} encoder + {cfg.dec_layers} self + "
        f"{cfg.dec_layers} cross); {GEN_NEW} greedy decode steps: p50 "
        f"{gen['decode_ms_p50']:.2f} p99 {gen['decode_ms_p99']:.2f} ms, #3 "
        f"0 per step, the cross K/V carried unchanged; {gen['tok_s']:.1f} "
        f"generated tok/s; peak {peak:.2f} GiB; {CARD[0]}")
    del caches, state, cross
    f["parts_s"]["generate"] = time.perf_counter() - t0

    # scoring: 2 × (256 frames + 1,024 tokens) through Model.loss
    t0 = time.perf_counter()
    sb, sl = ENCDEC_SCORE
    rng = np.random.default_rng(5)
    score = {"frames": (torch.randn((sb, cfg.frontend_len, cfg.d_model),
                                    generator=g, device=DEV) * 0.05
                        ).to(torch.bfloat16),
             "tokens": torch.from_numpy(rng.integers(
                 0, cfg.vocab_size, (sb, sl)).astype(np.int32)).to(DEV)}
    reset_streaming_counts()
    s0 = time.perf_counter()
    loss = float(m.loss(params, score)[0])
    wall = (time.perf_counter() - s0) * 1e3
    expect_variant("seamless scoring", VARIANT[cfg.dtype], per)
    launches = streaming_attention.launches
    losses = [loss] + [float(build_model(cfg.replace(attn_backend=be)).loss(
        params, score)[0]) for be in ("naive", "jnp")]
    f["scoring"] = dict(launches=launches, ms=wall, loss=hold_loss(
        "seamless scoring loss", losses, floor=1e-3))
    log(f"[seamless scoring] {sb} × ({cfg.frontend_len} frames + {sl} "
        f"tokens): loss {loss:.4f} through the kernel ({launches} launches, "
        f"{wall:.0f} ms incl. the first call), {losses[1]:.4f} plain (ln V "
        f"= {np.log(cfg.vocab_size):.4f})")
    f["parts_s"]["scoring"] = time.perf_counter() - t0
    del params, m
    torch.cuda.empty_cache()
    return f


# ------------------------------------------------------------- phase 16 --

# Phase 16: training through ``Trainer.run()`` (name, layers kept — None:
# full depth —, steps, AdamW moment dtype, (batch, sequence), whether the
# run checkpoints and recovers): bert-large bidirectional at head dim 64,
# deepseek-7b causal at 128 cut to 4 of 30 layers (its 6.9 B parameters
# in bf16 with f32 AdamW moments and the gradients need ~83 GB), and at
# head dim 256 gemma2-9b cut to 4 of 42 layers (2 local + 2 global; its
# window of 4,096 does not bite at 512 tokens) and gemma3-12b cut to 6 of
# 48 (one whole 5 local : 1 global period) at 2 × 2,048 tokens, so that
# its local window of 1,024 bites (whole, ~18.5 and ~24 GB of bf16
# weights, 4× that with AdamW's moments and the gradients).
# TrainConfig's defaults otherwise (the reference's: lr 3e-4, warmup 10,
# clip 1.0).  A recovering run writes a checkpoint every TRAIN_CKPT_EVERY
# steps, one kept, fails at TRAIN_FAIL_AT, restores step 3's checkpoint
# and resumes.  deepseek's state is 9.9 GB a checkpoint with bf16 moments
# (16.5 with f32), and every checkpoint goes to disk: bf16 moments (the
# reference's ``moment_dtype`` option) and 6 steps (2 checkpoints) keep
# the script's disk writes near 30 GB; the gemmas (10–14 GB a checkpoint)
# take none, recovery being held on the first two.
#
# Then the families that train through #1's backward kernel, 4 steps,
# bf16 moments, no checkpoint (recovery is held on the first two):
# granite-moe-3b-a800m at full
# depth, 8 × 512 (~26 GB of state with bf16 moments, ~90 KB a token a
# layer of saved activations); zamba2-1.2b at full depth, **4 × 512**
# (its Mamba-2 chunks save ~450 KB a token a layer, measured on the CPU
# at its width: ~70 GB at 8 × 512); falcon-mamba-7b **cut to 2 of 64
# layers** (~14.6 GB of bf16 weights whole, 4× with moments and
# gradients) at **2 × 512** (its chunk Ā is 512 KB a token a layer in
# f32, ~5.2 MB with the log-depth scan's intermediates).
TRAIN_MODELS = (("bert-large", None, 8, "float32", (8, 512), True),
                ("deepseek-7b", 4, 6, "bfloat16", (8, 512), True),
                ("gemma2-9b", 4, 4, "bfloat16", (8, 512), False),
                ("gemma3-12b", 6, 4, "bfloat16", (2, 2048), False),
                ("granite-moe-3b-a800m", None, 4, "bfloat16", (8, 512),
                 False),
                ("zamba2-1.2b", None, 4, "bfloat16", (4, 512), False),
                ("falcon-mamba-7b", 2, 4, "bfloat16", (2, 512), False))
# The models whose step 0 is held against #1's plain version under
# autograd (``step0_plain_lut``) instead of the plain attention
TRAIN_LUT_MODELS = ("granite-moe-3b-a800m", "zamba2-1.2b", "falcon-mamba-7b")
TRAIN_LUT_FLOOR = 1e-5
# #1's backward at phase 16's training shapes, f32 as the models call it
# (label, shape, inputs drawn in [-hi, 0]): granite-moe's router softmax
# (8 · 512 tokens × 40 experts), falcon-mamba's chunk Ā (B 2, 128 rows,
# d_inner 8192, state 16) and zamba2's four Mamba-2 exponentials a chunk
# (B 4, 64 heads, chunk 128): the intra-chunk decay, exp(s_cum) and the
# tail, exp(s_end)
LUT_BWD_SHAPES = (
    ("granite-moe router (8·512, 40)", (8 * 512, 40), 16.0),
    ("falcon-mamba chunk Ā (2, 128, 8192, 16)", (2, 128, 8192, 16), 16.0),
    ("zamba2 intra-chunk decay (4, 64, 128, 128)", (4, 64, 128, 128), 60.0),
    ("zamba2 exp(s_cum) / tail (4, 128, 64)", (4, 128, 64), 60.0),
    ("zamba2 exp(s_end) (4, 64)", (4, 64), 60.0))
# The backward's edges: the underflow cut and both sides of it, 0, a large
# input, the non-finite ones (a run in [-87, -70] with small gradients
# follows them)
LUT_BWD_EDGES = (-1e30, -87.0, -86.99, 0.0, 88.0, float("inf"),
                 float("-inf"), float("nan"))
TRAIN_CKPT_EVERY, TRAIN_FAIL_AT = 3, (4,)
# Step 0 with the plain attention on the card (the scan's custom VJP) at
# two blockings: the kernel's loss and gradient norm must sit within 3×
# their spread, and within these relative floors (bf16: each attention
# output rounds once, at another place in each schedule).
TRAIN_TWIN_FLOOR = {"loss": 2e-3, "grad_norm": 2e-2}
# Models whose step 0 is held in f32 (the kernel path's f32 kernels against
# the plain attention in f32, the same rule), the bf16 readings logged
# beside.  Under the reference's labels (each position scored against its
# own token) a tied-embedding model predicts them from the start, so
# gemma3-12b's step-0 loss is ~2e-4, set by a few near-tied tokens, and in
# bf16 the rounding of the whole network decides it: measured on an H100,
# bf16 moved it 18% and the gradient norm 43% from f32, and the plain
# attention's blockings 512, 64 and 32 lay 2% and 4% apart, while in f32
# the kernel path held the plain one within 3e-5 and 5e-5.
TRAIN_TWIN_F32 = ("gemma3-12b",)
# The backward kernel against its plain version, from the forward kernel's
# own out and lse: (label, (B, Hq, Hkv, Lq, Lkv, D), keywords).
BWD_SHAPES = (
    ("bert-large 8x512", (8, 16, 16, 512, 512, 64), {}),
    ("deepseek-7b 8x512 causal", (8, 32, 32, 512, 512, 128),
     dict(causal=True)),
    ("grok 2x1024 (GQA 6:1, cap 30)", (2, 48, 8, 1024, 1024, 128),
     dict(causal=True, cap=30.0)),
    ("seamless cross 8x16 rows vs 256 frames", (8, 16, 16, 16, 256, 64), {}),
    ("window 128, kv_len 400, q_offset 100 (GQA 4:1)",
     (2, 32, 8, 300, 420, 128),
     dict(causal=True, window=128, kv_len=400, q_offset=100)),
    # head dim 256: gemma2-9b's training batch (every layer: its window
    # does not bite at 512), gemma3-12b's local and global layers
    ("gemma2-9b 8x512 (GQA 2:1, cap 50)", (8, 16, 8, 512, 512, 256),
     dict(causal=True, cap=50.0)),
    ("gemma3-12b 2x2048 local (GQA 2:1, window 1024)",
     (2, 16, 8, 2048, 2048, 256), dict(causal=True, window=1024)),
    ("gemma3-12b 2x2048 global (GQA 2:1)", (2, 16, 8, 2048, 2048, 256),
     dict(causal=True)))
# max|kernel − plain| over max|plain|, per gradient: f32 sums in another
# order over up to 6 × 1,024 rows; bf16 within one bf16 ulp of the
# largest element (both sides round their f32 sums once to bf16).
BWD_TOL = {"float32": 3e-5, "bfloat16": 2.0 ** -7}


def reset_training_counts():
    from repro_torch.kernels.lut_exp import lut_exp
    from repro_torch.kernels.streaming_attention.ops import (
        streaming_attention_bwd)
    reset_streaming_counts()
    streaming_attention_bwd.launches = 0
    for v in streaming_attention_bwd.launches_by_variant:
        streaming_attention_bwd.launches_by_variant[v] = 0
    lut_exp.launches = 0
    lut_exp.bwd_launches = 0


def read_training_counts():
    from repro_torch.kernels.lut_exp import lut_exp
    from repro_torch.kernels.streaming_attention.ops import (
        streaming_attention, streaming_attention_bwd)
    return dict(fwd=streaming_attention.launches,
                fwd_by_variant=dict(streaming_attention.launches_by_variant),
                bwd=streaming_attention_bwd.launches,
                bwd_by_variant=dict(streaming_attention_bwd.launches_by_variant),
                lut_exp=lut_exp.launches, lut_exp_bwd=lut_exp.bwd_launches)


def attention_calls(cfg) -> int:
    """#3's forward launches in one training forward: one per attention
    layer, one per period for the hybrid's shared block, none for
    Mamba-1."""
    from repro_torch.models.lm import period_layout
    if cfg.family == "hybrid":
        return period_layout(cfg)[1]
    return 0 if cfg.family == "ssm" else cfg.num_layers


def lut_launches_per_step(cfg, seq):
    """#1's (forward, backward) launches in one training step at the LUT's
    order 1: the router, once per MoE layer each way; Mamba-1's Ā, once
    per chunk per layer each way; Mamba-2's four exponentials a chunk per
    layer forward, and backward all but the last chunk's two that carry
    the state (the final state feeds no loss, so autograd never reaches
    them); none elsewhere (#3 inlines its own)."""
    if cfg.family == "moe":
        return cfg.num_layers, cfg.num_layers
    if cfg.family in ("ssm", "hybrid"):
        chunks = -(-seq // cfg.ssm_chunk)
        if cfg.ssm_variant == "mamba2":
            fwd = cfg.num_layers * 4 * chunks
            return fwd, fwd - 2 * cfg.num_layers
        return cfg.num_layers * chunks, cfg.num_layers * chunks
    return 0, 0


def bwd_inputs(shape, dtype, kw, seed):
    """q, k, v, the forward kernel's (out, lse) and a random dout."""
    import torch
    from repro_torch.kernels.streaming_attention.ops import (
        streaming_attention_lse)
    q, k, v = sa_inputs(shape, dtype, seed)
    g = torch.Generator(device=DEV).manual_seed(seed + 1)
    dout = torch.randn(q.shape, generator=g, device=DEV).to(q.dtype)
    out, lse = streaming_attention_lse(q, k, v, **kw)
    return q, k, v, out, lse, dout


def phase_backward_checks():
    """The backward kernel against its plain version (``attention_bwd_ref``
    on the card) at ``BWD_SHAPES``, bf16 and f32, fed the forward kernel's
    out and lse (the lse itself held to the plain forward's); a second
    call must give the same bits (no atomics)."""
    import torch
    from repro_torch.kernels.streaming_attention.ops import (
        attention_bwd_ref, attention_lse_ref, streaming_attention_bwd)
    out = {}
    for label, shape, kw in BWD_SHAPES:
        for dtype in ("float32", "bfloat16"):
            q, k, v, o, lse, dout = bwd_inputs(shape, dtype, kw, seed=31)
            scale = shape[-1] ** -0.5
            got = streaming_attention_bwd(q, k, v, o, lse, dout, scale=scale,
                                          **kw)
            again = streaming_attention_bwd(q, k, v, o, lse, dout,
                                            scale=scale, **kw)
            want = attention_bwd_ref(q, k, v, o, lse, dout, scale=scale, **kw)
            _, plain_lse = attention_lse_ref(q, k, v, scale=scale, **kw)
            torch.cuda.synchronize()
            errs, abs_errs = {}, {}
            for name, a, w in zip(("dq", "dk", "dv"), got, want):
                if not torch.isfinite(a).all():
                    fail(f"backward {label} {dtype}: {name} not finite")
                big = float(w.float().abs().max())
                abs_errs[name] = float((a.float() - w.float()).abs().max())
                errs[name] = abs_errs[name] / big
            lse_err = float((lse - plain_lse).abs().max())
            det = all(torch.equal(a, b) for a, b in zip(got, again))
            tol = BWD_TOL[dtype]
            log(f"[backward {label} {dtype}] kernel vs plain, max|Δ| / "
                f"max|plain|: " + ", ".join(f"{n} {e:.3g}" for n, e in
                                            errs.items())
                + f" (limit {tol:.3g}); lse max|Δ| {lse_err:.3g} (limit "
                f"1e-4); two calls bit-equal: {det}")
            if max(errs.values()) > tol:
                fail(f"backward {label} {dtype}: {errs} over {tol}")
            if lse_err > 1e-4:
                fail(f"backward {label} {dtype}: lse {lse_err} over 1e-4")
            if not det:
                fail(f"backward {label} {dtype}: two calls differ")
            out[f"{label} {dtype}"] = dict(rel_err=errs, abs_err=abs_errs,
                                           lse_err=lse_err, limit=tol,
                                           deterministic=det)
            del q, k, v, o, lse, dout, got, again, want, plain_lse
            torch.cuda.empty_cache()
    return out


def profiled_kernel_ms(fn, label, *, calls=10):
    """The device time of one call of ``fn`` alone from the profiler: the
    sum of its kernels' durations over ``calls`` calls (after one
    warm-up), over ``calls`` → (ms or None, kernel records, launch calls).
    None where the trace's kernel records are not one per launch call
    (records lost) or there is none.  The trace is kept gzipped under
    ``chiprun_out/traces``."""
    import gzip
    import torch
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    tdir = ROOT / "chiprun_out" / "traces"
    tdir.mkdir(parents=True, exist_ok=True)
    path = tdir / f"{label}.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    with open(path, "rb") as f_in, gzip.open(str(path) + ".gz", "wb") as f_out:
        f_out.write(f_in.read())
    os.remove(path)
    spans = [e for e in events if e.get("ph") == "X"]
    kernels = [float(e["dur"]) for e in spans if e.get("cat") == "kernel"]
    launches = sum(1 for e in spans
                   if e.get("cat") in ("cuda_runtime", "cuda_driver")
                   and "Launch" in e.get("name", ""))
    ok = bool(kernels) and len(kernels) == launches
    return (sum(kernels) / 1e3 / calls if ok else None), len(kernels), launches


def time_streaming_bwd(flush, launches, cases=BWD_SHAPES):
    """The backward kernel at ``BWD_SHAPES`` in bf16 (the main path's
    dtype): its time as a caller sees it and on the device alone, the
    plain backward's, and at the cap-free shapes SDPA's forward plus
    backward (exact exp: the library column, not the same function) as a
    caller sees it, on the device alone (~1 ms of spin ahead) and as its
    kernels' sum in a profiler trace (free of autograd's host work),
    beside the bound (``cases``: other shapes in ``BWD_SHAPES``' form).
    Bytes: q, k, v, out, dout read once and lse, dq,
    dk, dv written or read once; operations: the five
    products of the reference's backward (S, dP, dV, dQ, dK: 10·D per
    visible pair) at the bf16 tensor-core peak."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.streaming_attention.ops import (
        attention_bwd_ref, streaming_attention_bwd)
    shapes = {}
    for label, shape, kw in cases:
        b, hq, hkv, lq, lkv, d = shape
        q, k, v, o, lse, dout = bwd_inputs(shape, "bfloat16", kw, seed=37)
        scale = d ** -0.5
        ms = cuda_ms(lambda: streaming_attention_bwd(
            q, k, v, o, lse, dout, scale=scale, **kw), flush=flush)
        device = cuda_ms(lambda: streaming_attention_bwd(
            q, k, v, o, lse, dout, scale=scale, **kw), flush=flush, spin=True)
        plain = cuda_ms(lambda: attention_bwd_ref(
            q, k, v, o, lse, dout, scale=scale, **kw), iters=3, flush=flush)
        lib = lib_device = lib_spin = None
        if not kw.get("cap"):
            qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
            fwd = sdpa_for(qs, ks, vs, kw)

            def lib_call():
                torch.autograd.grad(fwd(), (qs, ks, vs), dout)
            lib = cuda_ms(lib_call, flush=flush)
            lib_spin = cuda_ms(lib_call, flush=flush, spin=True)
            lib_device, n_kernels, n_launches = profiled_kernel_ms(
                lib_call, "sdpa_fwd_bwd_" + "_".join(label.split()[:3]))
        keys = kw.get("kv_len") or lkv
        nbytes = 2.0 * (4 * b * hq * lq * d + 4 * b * hkv * keys * d) \
            + 4.0 * b * hq * lq
        flops = 10.0 * b * hq * d * visible_pairs(
            lq, lkv, causal=kw.get("causal", False), window=kw.get("window"),
            kv_len=kw.get("kv_len"), q_offset=kw.get("q_offset", 0))
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
        shapes[label] = dict(
            ms=ms, device_ms=device, plain_ms=plain,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=lib, library_device_ms=lib_device,
            library_spin_ms=lib_spin,
            tflops=flops / ms / 1e9, gflop=flops / 1e9,
            bound_share=max(t_bytes, t_ops) / ms,
            shape=f"B {b}, {hq} × {hkv} heads × {d}, Lq {lq}, Lkv {lkv}, "
                  f"bf16, {kw}")
        log(f"[time] streaming_attention_bwd {label}: kernel {ms:.4f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s; device alone {device:.4f} ms), "
            f"plain {plain:.3f} ms, "
            + ("sdpa fwd+bwd none (softcap)" if lib is None else
               f"sdpa fwd+bwd {lib:.4f} ms (device alone {lib_spin:.4f} ms; "
               f"its kernels by the profiler "
               + (f"{lib_device:.4f} ms" if lib_device is not None else
                  f"not measured: {n_kernels} kernel records for "
                  f"{n_launches} launch calls")
               + ")")
            + f", bound {max(t_bytes, t_ops):.4f} ms ({nbytes / 1e6:.1f} MB, "
            f"{flops / 1e9:.2f} GFLOP; the kernel at "
            f"{100 * max(t_bytes, t_ops) / ms:.1f}% of it); {CARD[0]}")
        del q, k, v, o, lse, dout
        torch.cuda.empty_cache()
    first = shapes[cases[0][0]]
    return dict(
        name="streaming_attention_bwd", route="cuda",
        source="src/repro_torch/csrc/streaming_attention_bwd.cu",
        replaces="src/repro/core/attention_api.py:313 (attn_bwd, the custom "
                 "VJP of the Pallas kernel: src/repro/core/"
                 "streaming_attention.py:152 _bwd)",
        launches=sum(launches.values()), launches_by_path=launches,
        max_abs_err=None, **{k: first[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        library="scaled_dot_product_attention forward + backward (exact "
                "exp, not the same function)",
        shapes=shapes)


def train_step_window(tr, label):
    """One more training step of ``tr`` (its step function on the next
    batch, outside ``run``: no checkpoint) under the profiler → the
    window's device time by group."""
    import torch
    tdir = ROOT / "chiprun_out" / "traces"
    tdir.mkdir(parents=True, exist_ok=True)
    path = str(tdir / f"{label.replace(' ', '_')}_train_step.json")
    batch = tr._device_batch(tr.step)
    step = torch.tensor(tr.step, dtype=torch.int32, device=DEV)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        out = tr._train_step(tr.params, tr.opt_state, tr.residual, batch,
                             step)
        float(out[3]["loss"])
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    del out
    return read_window(path, f"{label} training step")


def train_model(name, cut, steps, moment_dtype, shape, recover):
    """Phase 16 for one model (see ``TRAIN_MODELS``): the main path is
    ``Trainer.run()`` — with ``recover``, with checkpoints and a
    ``FailureInjector``, and its losses must equal those of an
    uninterrupted run (no checkpoints) bit for bit."""
    import dataclasses
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig
    from repro_torch.runtime import FailureInjector, TrainConfig, Trainer
    cfg = get_config(name)
    if cut:
        cfg = cfg.replace(num_layers=cut)
    short = name.split("-")[0]
    batch, seq = shape
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=batch, corpus="lm")
    f = dict(layers=cfg.num_layers, steps=steps, moment_dtype=moment_dtype,
             batch=batch, seq=seq, recover=recover, parts_s={})
    t_part = [time.perf_counter()]

    def part(what):
        now = time.perf_counter()
        f["parts_s"][what] = now - t_part[0]
        t_part[0] = now

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        tcfg = TrainConfig(steps=steps, ckpt_dir=tmp if recover else None,
                           ckpt_every=TRAIN_CKPT_EVERY, keep_ckpts=1,
                           moment_dtype=moment_dtype)
        tr = Trainer(cfg, dcfg, tcfg, device=DEV)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_training_counts()
        t0 = time.perf_counter()
        metrics = tr.run(injector=FailureInjector(
            fail_at_steps=TRAIN_FAIL_AT) if recover else None)  # the main path
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_training_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        n_params = sum(p.numel() for p in tr.params.values())
        f["checkpoints"] = sorted(os.listdir(tmp))
        part("main run")
        # every step once, and after a failure the steps after the
        # restored checkpoint again up to it
        restored = max(s for s in range(0, TRAIN_FAIL_AT[0] + 1,
                                        TRAIN_CKPT_EVERY))
        ran = steps + (TRAIN_FAIL_AT[0] - restored if recover else 0)
        want = attention_calls(cfg) * ran
        if counts["fwd"] != want or counts["bwd"] != want:
            fail(f"train {name}: #3 forward {counts['fwd']} and backward "
                 f"{counts['bwd']} launches, expected attention calls × "
                 f"steps run = {attention_calls(cfg)} × {ran}")
        if counts["fwd_by_variant"]["tensor_core"] != want \
                or counts["bwd_by_variant"]["tensor_core"] != want:
            fail(f"train {name}: launches by variant {counts}")
        lut_fwd, lut_bwd = lut_launches_per_step(cfg, seq)
        if (counts["lut_exp"], counts["lut_exp_bwd"]) != (lut_fwd * ran,
                                                          lut_bwd * ran):
            fail(f"train {name}: #1 forward {counts['lut_exp']} and backward "
                 f"{counts['lut_exp_bwd']} launches, expected ({lut_fwd}, "
                 f"{lut_bwd}) a step × {ran}")
        # the replayed steps appear twice in the log: the same bits again
        by_step = {}
        for m in metrics:
            if m["step"] in by_step and m["loss"] != by_step[m["step"]]["loss"]:
                fail(f"train {name}: step {m['step']} replayed after the "
                     f"restore gave loss {m['loss']}, first "
                     f"{by_step[m['step']]['loss']}")
            by_step[m["step"]] = m
        metrics = [by_step[i] for i in sorted(by_step)]
        loss = [m["loss"] for m in metrics]
        gnorm = [m["grad_norm"] for m in metrics]
        if sorted(by_step) != list(range(steps)) \
                or not np.all(np.isfinite(loss + gnorm)):
            fail(f"train {name}: steps {sorted(by_step)}, losses {loss}, "
                 f"grad norms {gnorm}")
        step_ms = [m["ms"] for m in metrics[1:]]
        p50 = float(np.percentile(step_ms, 50))
        f.update(params_b=n_params / 1e9, losses=loss, grad_norms=gnorm,
                 lrs=[m["lr"] for m in metrics],
                 step_ms=[m["ms"] for m in metrics], step_ms_p50=p50,
                 tok_s=batch * seq / p50 * 1e3, peak_gib=peak,
                 wall_s=wall, steps_run=ran, launches=counts)
        f["window"] = train_step_window(tr, short)
        log(f"[train {name}] {cfg.num_layers} layers"
            + (f" (cut from {get_config(name).num_layers})" if cut else "")
            + f", {n_params / 1e9:.2f} B parameters, {moment_dtype} moments, "
            f"{batch} × {seq} tokens, {steps} steps through Trainer.run() "
            + (f"with a checkpoint every {TRAIN_CKPT_EVERY} and a failure at "
               f"{TRAIN_FAIL_AT} (restored step {restored}), " if recover
               else "without checkpoints, ")
            + f"{ran} steps run in {wall:.1f} s: losses "
            f"{[round(x, 4) for x in loss]}, grad norms "
            f"{[round(x, 3) for x in gnorm]}; step ms p50 {p50:.1f} (steps "
            f"1–{steps - 1}), {f['tok_s']:.0f} tok/s; peak {peak:.2f} GiB; "
            f"#3 forward {counts['fwd']} and backward {counts['bwd']} "
            f"launches = {attention_calls(cfg)} attention calls × {ran} "
            f"steps run (backward by variant {counts['bwd_by_variant']}); "
            f"#1 forward {counts['lut_exp']} and backward "
            f"{counts['lut_exp_bwd']} = {lut_launches_per_step(cfg, seq)}"
            f" a step × {ran}; "
            f"checkpoints left {f['checkpoints']}; {CARD[0]}")
        del tr
        torch.cuda.empty_cache()
        part("profiled step")

    plain = dataclasses.replace(tcfg, ckpt_dir=None)
    if recover:
        tu = Trainer(cfg, dcfg, plain, device=DEV)
        mu = tu.run()
        del tu
        torch.cuda.empty_cache()
        same = [m["loss"] for m in mu] == loss
        log(f"[train {name}] the run with a failure at {TRAIN_FAIL_AT}, "
            f"resumed from step {restored}'s checkpoint, against an "
            f"uninterrupted run without checkpoints: losses of all {steps} "
            f"steps bit-equal: {same}")
        if not same:
            fail(f"train {name}: recovered losses {loss} differ from the "
                 f"uninterrupted {[m['loss'] for m in mu]}")
        f["recovery_bit_exact"] = same
        part("uninterrupted run")

    if name in TRAIN_LUT_MODELS:
        f["step0_vs_plain_lut"] = hold_step0_plain_lut(name, cfg, dcfg,
                                                       metrics[0])
        part("plain twins")
        return f
    f32 = name in TRAIN_TWIN_F32
    c = cfg.replace(dtype="float32") if f32 else cfg
    kernel = step0(c, dcfg) if f32 else metrics[0]
    twins = {blk: step0(c.replace(attn_backend="jnp", block_k=blk), dcfg)
             for blk in (512, 64)}
    held = {}
    for key, floor in TRAIN_TWIN_FLOOR.items():
        a, b = twins[512][key], twins[64][key]
        err = abs(kernel[key] - a) / abs(a)
        spread = abs(a - b) / abs(a)
        tol = max(3 * spread, floor)
        held[key] = dict(kernel=kernel[key], plain=a, plain_64=b,
                         rel_err=err, spread=spread, limit=tol)
        if err > tol:
            fail(f"train {name}: step 0 {key} {kernel[key]} vs the "
                 f"plain attention's {a}: {err:.3g} over {tol:.3g}")
    f["step0_vs_plain"] = dict(held, dtype=c.dtype)
    log(f"[train {name}] step 0 against the plain attention on the card "
        f"in {c.dtype} (the scan's custom VJP, 512- and 64-key blocks): "
        + "; ".join(f"{k} {v['kernel']:.6g} vs {v['plain']:.6g} "
                    f"(rel {v['rel_err']:.3g}, spread {v['spread']:.3g}, "
                    f"limit {v['limit']:.3g})" for k, v in held.items()))
    if f32:
        bf = step0(cfg.replace(attn_backend="jnp", block_k=512), dcfg)
        f["step0_bf16_not_held"] = dict(kernel=metrics[0]["loss"],
                                        plain=bf["loss"],
                                        kernel_grad_norm=metrics[0]["grad_norm"],
                                        plain_grad_norm=bf["grad_norm"])
        log(f"[train {name}] step 0 in bfloat16, logged and not held "
            f"(TRAIN_TWIN_F32): loss {metrics[0]['loss']:.6g} vs the plain "
            f"attention's {bf['loss']:.6g} (f32: {held['loss']['plain']:.6g})"
            f", grad norm {metrics[0]['grad_norm']:.6g} vs "
            f"{bf['grad_norm']:.6g} (f32: {held['grad_norm']['plain']:.6g})")
    part("plain twins")
    return f


def step0(cfg, dcfg):
    """Step 0's loss and gradient norm as ``Trainer.run`` logs them — the
    parameters its generator draws from ``TrainConfig.seed``, the
    pipeline's first batch, the gradients' global norm before clipping —
    without the optimizer's state (an f32 AdamW over a full-width model
    would not fit beside it)."""
    import torch
    from repro_torch.data import TokenPipeline
    from repro_torch.models import build_model
    from repro_torch.optim import accumulated_grads, global_norm
    from repro_torch.runtime import TrainConfig
    model = build_model(cfg)
    params = model.init(torch.Generator(device=DEV).manual_seed(
        TrainConfig().seed), DEV)
    batch = {k: torch.from_numpy(v).to(DEV)
             for k, v in TokenPipeline(dcfg).shard_batch(0).items()}
    loss, grads, _ = accumulated_grads(model.loss, params, batch, 1)
    out = dict(loss=float(loss), grad_norm=float(global_norm(grads)))
    del params, grads
    torch.cuda.empty_cache()
    return out


def step0_plain_lut(cfg, dcfg, deterministic=False):
    """``step0`` with #1 replaced, where the models call it (``models.moe``,
    ``models.mamba``), by its plain version under autograd (the plain
    graph on the card: no #1 launch).  With ``deterministic``, under
    ``torch.use_deterministic_algorithms(True, warn_only=True)``, which
    names each reduction that has no deterministic kernel (``warnings``)."""
    import warnings
    import torch
    import repro_torch.models.mamba as mamba
    import repro_torch.models.moe as moe
    from repro_torch.kernels.lut_exp import lut_exp, lut_exp_ref
    saved = (mamba.lut_exp, moe.lut_exp)
    before = (lut_exp.launches, lut_exp.bwd_launches)
    mamba.lut_exp = moe.lut_exp = (
        lambda z, order=1: lut_exp_ref(z, order=order))
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(deterministic, warn_only=True)
            try:
                out = step0(cfg, dcfg)
            finally:
                torch.use_deterministic_algorithms(False)
    finally:
        mamba.lut_exp, moe.lut_exp = saved
    if (lut_exp.launches, lut_exp.bwd_launches) != before:
        fail(f"step 0 with the plain #1 launched #1: {before} → "
             f"{(lut_exp.launches, lut_exp.bwd_launches)}")
    if deterministic:
        out["warnings"] = sorted({str(w.message).split(". ")[0][:160]
                                  for w in caught})
    return out


def hold_step0_plain_lut(name, cfg, dcfg, kernel):
    """Step 0 of the run through #1's kernels (``kernel``: its logged loss
    and gradient norm) against two runs with #1's plain version: the loss
    bit for bit (the forward kernel is bit-exact and the forward has no
    atomics), the gradient norm within max(3 × the two plain runs' spread,
    ``TRAIN_LUT_FLOOR``) relative (the backward kernel is bit-exact too:
    what moves the norm is a reduction whose order varies from run to run,
    which a third plain run under ``use_deterministic_algorithms``'s
    warn-only mode names)."""
    plain = [step0_plain_lut(cfg, dcfg) for _ in range(2)]
    det = step0_plain_lut(cfg, dcfg, deterministic=True)
    a, b = plain[0]["grad_norm"], plain[1]["grad_norm"]
    err = abs(kernel["grad_norm"] - a) / abs(a)
    spread = abs(a - b) / abs(a)
    limit = max(3 * spread, TRAIN_LUT_FLOOR)
    out = dict(loss=kernel["loss"], plain_loss=[p["loss"] for p in plain],
               grad_norm=kernel["grad_norm"], plain_grad_norm=[a, b],
               rel_err=err, spread=spread, limit=limit,
               deterministic_grad_norm=det["grad_norm"],
               nondeterministic=det["warnings"])
    log(f"[train {name}] step 0 against #1's plain version under autograd "
        f"on the card: loss {kernel['loss']!r} vs {plain[0]['loss']!r} / "
        f"{plain[1]['loss']!r} (bit for bit); grad norm "
        f"{kernel['grad_norm']!r} vs {a!r} / {b!r} (rel {err:.3g}, two plain "
        f"runs' spread {spread:.3g}, limit {limit:.3g}); deterministic "
        f"algorithms: grad norm {det['grad_norm']!r}, warnings "
        + json.dumps(det["warnings"]))
    if any(p["loss"] != kernel["loss"] for p in plain):
        fail(f"train {name}: step 0 loss {kernel['loss']!r} differs from the "
             f"plain #1's {[p['loss'] for p in plain]}")
    if err > limit:
        fail(f"train {name}: step 0 grad norm {kernel['grad_norm']} vs the "
             f"plain #1's {a}: {err:.3g} over {limit:.3g}")
    return out


def phase_training():
    """Phase 16: ``TRAIN_MODELS`` through ``Trainer.run()``, one at a
    time."""
    return {m[0]: train_model(*m) for m in TRAIN_MODELS}


# --------------------------------------------------------- phase 17: TP --

def tp_checks(axis):
    """The paper's multi-core softmax and the ring attention across the
    ranks of ``axis`` (each rank's block of seeded inputs drawn whole on
    every rank), held against their plain single-device versions on the
    card → facts of this rank's run."""
    import torch
    from repro_torch.core import (distributed_decode_attention,
                                  ring_attention, sharded_softmax,
                                  sharded_softmax_tree, tree_allreduce)
    from repro_torch.core import multicore_softmax
    from repro_torch.core.lut_softmax import lut_softmax
    from repro_torch.core.streaming_attention import naive_attention
    from repro_torch.kernels.lut_exp import lut_exp
    from repro_torch.parallel.collectives import all_gather
    n, r = axis.size, axis.index
    g = torch.Generator(device=DEV).manual_seed(17)
    out = {}
    # the sampler's shape, split on the vocabulary
    x = torch.randn(TP_SOFTMAX, generator=g, device=DEV) * 5
    cols = x.shape[1] // n
    local = x[:, r * cols:(r + 1) * cols].contiguous()
    want = lut_softmax(x, exp=lut_exp)
    l0, c0 = lut_exp.launches, multicore_softmax.COUNTS["tree_rounds"]
    t0 = time.perf_counter()
    got = all_gather(sharded_softmax(local, axis), axis, dim=1)
    torch.cuda.synchronize()
    out["softmax_ms"] = (time.perf_counter() - t0) * 1e3
    l1, c1 = lut_exp.launches, multicore_softmax.COUNTS["tree_rounds"]
    tree = all_gather(sharded_softmax_tree(local, axis), axis, dim=1)
    c2 = multicore_softmax.COUNTS["tree_rounds"]
    one = tree_allreduce(torch.ones(4, device=DEV), torch.add, axis)
    c3 = multicore_softmax.COUNTS["tree_rounds"]
    out.update(
        softmax_err=float((got - want).abs().max()),
        softmax_tree_err=float((tree - got).abs().max()),
        softmax_lut_launches=l1 - l0,
        rounds=dict(sharded_softmax=c1 - c0, sharded_softmax_tree=c2 - c1,
                    tree_allreduce=c3 - c2),
        tree_sum=float(one[0]))
    # ring attention at deepseek's scoring shape, the sequence split
    b, h, seq, d = TP_RING
    q, k, v = (torch.randn((b, h, seq, d), generator=g, device=DEV)
               for _ in range(3))
    part = lambda t: t[:, :, r * (seq // n):(r + 1) * (seq // n)].contiguous()  # noqa: E731
    t0 = time.perf_counter()
    ring = all_gather(ring_attention(part(q), part(k), part(v), axis,
                                     causal=True), axis, dim=2)
    torch.cuda.synchronize()
    out["ring_ms"] = (time.perf_counter() - t0) * 1e3
    want = naive_attention(q, k, v, causal=True, exp_mode="lut")
    out["ring_err"] = float((ring - want).abs().max())
    out["ring_ok"] = bool(torch.allclose(ring, want, **TP_ATTN_TOL))
    # one decode row against the split cache of seq rows
    qd = torch.randn((b, h, 1, d), generator=g, device=DEV)
    t0 = time.perf_counter()
    dec = distributed_decode_attention(qd, part(k), part(v), axis,
                                       kv_len=seq)
    torch.cuda.synchronize()
    out["decode_ms"] = (time.perf_counter() - t0) * 1e3
    want = naive_attention(qd, k, v, causal=True, q_offset=seq - 1,
                           kv_len=seq, exp_mode="lut")
    out["decode_err"] = float((dec - want).abs().max())
    out["decode_ok"] = bool(torch.allclose(dec, want, **TP_ATTN_TOL))
    return out


def tp_rank(prompts, want):
    """One rank of phase 17 (started by ``launch.mesh.spawn`` into a gloo
    group of ``TP_RANKS`` on this card): phase 7's seeded deepseek-7b
    weights at full width, phase 7c's traffic through ``EngineCore(mesh=
    TP_RANKS)`` on each pool, rank 0's single-device eager twin (the other
    ranks wait at a barrier), then ``tp_checks`` → facts of this rank.
    ``want`` is phase 7c's captured streams per pool."""
    import hashlib
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import Mesh
    from repro_torch.params import init_params
    from repro_torch.parallel import collectives
    from repro_torch.serving import EngineCore
    rank = dist.get_rank()
    t_start = time.perf_counter()
    cfg = get_config(MODEL)
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0), DEV)
    torch.cuda.synchronize()
    facts = dict(rank=rank, weights_s=time.perf_counter() - t_start)
    traffic, sps = sampled_traffic(prompts)
    targets = frozenset((u, j) for u in range(len(prompts)) for j in (0, 1))
    serve = lambda eng, tg: serve_waves(eng, [traffic], tg)  # noqa: E731
    gather_s = [0.0]
    plain_gather = dist.all_gather

    def timed_gather(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = plain_gather(*a, **kw)
        torch.cuda.synchronize()
        gather_s[0] += time.perf_counter() - t0
        return r
    for tag, kv_quant in (("bf16", False), ("int8", True)):
        c = cfg.replace(kv_quant=kv_quant)
        make = lambda **kw: EngineCore(c, params, device=DEV,  # noqa: E731
                                       **dict(ENGINE, **kw))
        eng = make(mesh=TP_RANKS)
        collectives.reset_traffic()
        gather_s[0] = 0.0
        dist.all_gather = timed_gather
        try:
            run = serve(eng, targets)
        finally:
            dist.all_gather = plain_gather
        traffic_of_run = dict(collectives.TRAFFIC)
        width = eng.scheduler.token_buckets[-1]
        counts = read_paged_counts()
        measured = eng.measure_collective_bytes(width)
        set_paged_counts(counts)
        itemsize = torch.empty((), dtype=getattr(torch, c.dtype)).element_size()
        h = hashlib.sha256(json.dumps(run["streams"], sort_keys=True)
                           .encode()).digest()[:8]
        hashes = collectives.all_gather(
            torch.tensor([list(h)], dtype=torch.int64, device=DEV),
            eng.tp_axis, dim=0)
        f = dict(
            steps=run["steps"], keys=run["keys"], launches=run["launches"],
            trace_count=eng.trace_count, step_ms_p50=run["step_ms_p50"],
            step_ms_p99=run["step_ms_p99"], tok_s=run["tok_s"],
            wall_s=run["wall_s"], peak_gib=run["peak_gib"],
            gather_ms_per_step=gather_s[0] / run["steps"] * 1e3,
            gathers=traffic_of_run, width=width, measured_bytes=measured,
            bytes_per_token=eng.collective_bytes_per_token,
            wire_itemsize=itemsize,
            pool_shape=list(eng.kv.pool["k"].shape),
            pool_specs={k: list(v) for k, v in eng.pool_specs.items()},
            pages_in_use=eng.pages_in_use,
            free_pages=eng.kv.free_pages, num_pages=eng.kv.num_pages,
            ranks_agree=bool((hashes == hashes[0]).all()),
            streams=run["streams"])
        del eng
        torch.cuda.empty_cache()
        dist.barrier()
        if rank == 0:
            single = fresh_run(lambda: make(capture=False), serve)(targets)
            f["single_step_ms_p50"] = single["step_ms_p50"]
            f["single_step_ms_p99"] = single["step_ms_p99"]
            f["single_tok_s"] = single["tok_s"]
            f["single_identical"] = single["streams"] == run["streams"]
            f["logits_rows"] = len(run["logits"])
            f["logits_bit_equal"] = bool(
                set(run["logits"]) == set(single["logits"]) and all(
                    bits_equal(torch.from_numpy(run["logits"][t]),
                               torch.from_numpy(single["logits"][t]))
                    for t in run["logits"]))
            f["logits_max_gap"] = max(
                (float(np.abs(run["logits"][t] - single["logits"][t]).max())
                 for t in run["logits"] if t in single["logits"]),
                default=None)
            # the single-device eager streams stand for the mesh's (equal,
            # or the parent fails): held to phase 7c's captured streams
            f["forks_vs_phase7c"] = hold_by_margin(
                f"tp {tag} vs phase 7c", single["streams"], want[tag],
                fresh_run(lambda: make(capture=False), serve),
                fresh_run(make, serve), sampling=sps)
        facts[tag] = f
        dist.barrier()
    mesh = Mesh((TP_RANKS,), ("model",))
    facts["checks"] = tp_checks(mesh.axis("model"))
    facts["rank_s"] = time.perf_counter() - t_start
    return facts


def phase_tp_serving(prompts, want):
    """Phase 17 (see the module docstring) → its facts."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import spawn
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    log(f"[tp] {CARD[0]}; before spawning {TP_RANKS} ranks: "
        f"{free / 2 ** 30:.1f} of {total / 2 ** 30:.1f} GiB free on the card")
    # #2 at a rank's head band (a head count the kernel never ran at)
    band = get_config(MODEL).replace(
        num_heads=get_config(MODEL).num_heads // TP_RANKS,
        num_kv_heads=get_config(MODEL).num_kv_heads // TP_RANKS)
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=DEV)
    flush = lambda: flush_buf.zero_()  # noqa: E731
    decode = [(1, kv) for kv in decode_kv_lens()]
    counts = read_paged_counts()
    times = dict(
        time_decode=time_family_paged(
            band, decode, f"deepseek-7b band {band.num_heads} of "
            f"{band.num_heads * TP_RANKS} heads (mesh {TP_RANKS}) decode",
            flush, library=sdpa_gqa_decode),
        time_mixed=time_family_paged(
            band, [MIXED_CHUNK] + decode[:7], f"deepseek-7b band "
            f"{band.num_heads} heads (mesh {TP_RANKS}) mixed step", flush))
    set_paged_counts(counts)
    del flush_buf
    torch.cuda.empty_cache()
    t_spawn = time.perf_counter()
    ranks = spawn(tp_rank, TP_RANKS, prompts, want, timeout=TP_TIMEOUT_S)
    spawn_s = time.perf_counter() - t_spawn
    cfg = get_config(MODEL)
    facts = dict(band=times, spawn_s=spawn_s, launches={})
    for tag in ("bf16", "int8"):
        per = [r_[tag] for r_ in ranks]
        lead = per[0]
        streams = [p.pop("streams") for p in per]
        label = f"tp mesh {TP_RANKS} {tag}"
        if any(s_ != streams[0] for s_ in streams) or not all(
                p["ranks_agree"] for p in per):
            fail(f"{label}: the ranks served different streams")
        if not lead["single_identical"]:
            fail(f"{label}: the mesh streams differ from rank 0's "
                 f"single-device eager streams")
        if not lead["logits_bit_equal"]:
            fail(f"{label}: the logits rows of the first two tokens differ "
                 f"from the single-device engine's (max gap "
                 f"{lead['logits_max_gap']})")
        for r_, p in enumerate(per):
            want_n = cfg.num_layers * p["steps"]
            for k in ("paged_attention", "paged_combine"):
                if p["launches"][k] != want_n:
                    fail(f"{label} rank {r_}: {k} launched "
                         f"{p['launches'][k]} times, expected layers × steps "
                         f"= {want_n}")
            expect = p["bytes_per_token"] * p["width"] * p["wire_itemsize"] // 4
            if p["measured_bytes"] != expect or not expect:
                fail(f"{label} rank {r_}: measure_collective_bytes("
                     f"{p['width']}) = {p['measured_bytes']}, expected "
                     f"collective_bytes_per_token × width × "
                     f"{p['wire_itemsize']} / 4 = {expect}")
            if p["pages_in_use"] or p["free_pages"] != p["num_pages"]:
                fail(f"{label} rank {r_}: the pool is not drained "
                     f"({p['pages_in_use']} pages in use)")
            if p["pool_shape"][2] != cfg.num_kv_heads // TP_RANKS:
                fail(f"{label} rank {r_}: pool {p['pool_shape']} is not a "
                     f"head band")
        facts["launches"][tag] = {f"rank {r_}": p["launches"]
                                  for r_, p in enumerate(per)}
        facts[tag] = dict(per[0], rank1={k: per[1][k] for k in (
            "step_ms_p50", "gather_ms_per_step", "measured_bytes")})
        log(f"[{label}] {lead['steps']} eager mesh steps ({lead['trace_count']}"
            f" (T, P) keys), streams of both ranks = rank 0's single-device "
            f"eager streams token for token, the first two tokens' logits "
            f"rows ({lead['logits_rows']}) bit-equal; held to phase 7c's "
            f"captured streams: forks {lead['forks_vs_phase7c']}; mesh step "
            f"p50 {lead['step_ms_p50']:.2f} ms p99 {lead['step_ms_p99']:.2f} "
            f"(rank 1 {per[1]['step_ms_p50']:.2f}) beside the single-device "
            f"eager p50 {lead['single_step_ms_p50']:.2f} p99 "
            f"{lead['single_step_ms_p99']:.2f}; all-gathers "
            f"{lead['gather_ms_per_step']:.2f} ms of wall time a step "
            f"({lead['gathers']['all_gather_calls']} calls, "
            f"{lead['gathers']['all_gather_bytes'] / 1e6:.1f} MB received a "
            f"rank); {lead['tok_s']:.1f} generated tok/s (single "
            f"{lead['single_tok_s']:.1f}); #2 launches "
            f"{[p['launches'] for p in per]} = {cfg.num_layers} × steps on "
            f"each rank; measure_collective_bytes({lead['width']}) = "
            f"{lead['measured_bytes']} = {lead['bytes_per_token']} B/token "
            f"(the reference's f32 formula) × width × "
            f"{lead['wire_itemsize']}/4; pool band {lead['pool_shape']} "
            f"(spec {lead['pool_specs']['k']}), drained; peak "
            f"{lead['peak_gib']:.2f} GiB a rank")
    for r_, rk in enumerate(ranks):
        c = rk["checks"]
        if c["softmax_err"] > 3e-6 or c["softmax_tree_err"] > 1e-6:
            fail(f"tp rank {r_}: sharded softmax off by {c['softmax_err']} "
                 f"(tree {c['softmax_tree_err']})")
        rounds = (TP_RANKS - 1).bit_length()
        if c["rounds"] != dict(sharded_softmax=0,
                               sharded_softmax_tree=2 * rounds,
                               tree_allreduce=rounds) or \
                c["tree_sum"] != TP_RANKS:
            fail(f"tp rank {r_}: butterfly rounds {c['rounds']}, sum "
                 f"{c['tree_sum']} (log2 {TP_RANKS} = {rounds} a reduce)")
        if c["softmax_lut_launches"] != 1:
            fail(f"tp rank {r_}: sharded_softmax launched #1 "
                 f"{c['softmax_lut_launches']} times, not once")
        if not (c["ring_ok"] and c["decode_ok"]):
            fail(f"tp rank {r_}: ring attention max|Δ| {c['ring_err']}, "
                 f"distributed decode {c['decode_err']} (atol 5e-5, rtol "
                 f"1e-4)")
    c = ranks[0]["checks"]
    facts["checks"] = [rk["checks"] for rk in ranks]
    facts["rank_s"] = [rk["rank_s"] for rk in ranks]
    facts["weights_s"] = [rk["weights_s"] for rk in ranks]
    facts["phase_s"] = time.perf_counter() - t0
    log(f"[tp] multi-core softmax over {TP_RANKS} ranks at {TP_SOFTMAX} f32: "
        f"max|Δ| {c['softmax_err']:.3g} vs lut_softmax (limit 3e-6), tree "
        f"vs all-reduce {c['softmax_tree_err']:.3g} (limit 1e-6), butterfly "
        f"rounds {c['rounds']}, #1 once a call; {c['softmax_ms']:.2f} ms; "
        f"ring attention {TP_RING} causal max|Δ| {c['ring_err']:.3g} "
        f"({c['ring_ms']:.1f} ms), distributed decode at kv {TP_RING[2]} "
        f"max|Δ| {c['decode_err']:.3g} ({c['decode_ms']:.1f} ms), atol "
        f"5e-5 rtol 1e-4; ranks' seconds {[round(s_, 1) for s_ in facts['rank_s']]}"
        f" (weights {[round(s_, 1) for s_ in facts['weights_s']]}); spawn to "
        f"join {spawn_s:.1f} s; phase {facts['phase_s']:.1f} s")
    return facts


# ------------------------------------------- phase 18: TP training, pipeline --

def tp_band_attention(flush):
    """#3 and its backward at a rank's head band of phase 18's mesh (16 of
    deepseek-7b's 32 heads, 8 × 512 causal, bf16): each held to its plain
    version at that head count (the forward within one bf16 ulp beyond
    the f32 atol, the backward within ``BWD_TOL``), the band's output and
    gradients bit-equal to the same heads of the 32-head launch (a head's
    arithmetic does not depend on the launch's head count: what makes the
    mesh's step 0 the single device's), then timed beside their plain
    versions, SDPA and their bounds → facts."""
    import torch
    from repro_torch.kernels.streaming_attention.ops import (
        attention_bwd_ref, attention_ref, streaming_attention,
        streaming_attention_bwd, streaming_attention_lse)
    label, shape, kw = TP_BAND
    b, hq, hkv, lq, lkv, d = shape
    full = (b, hq * TP_RANKS, hkv * TP_RANKS, lq, lkv, d)
    q, k, v, o, lse, dout = bwd_inputs(full, "bfloat16", kw, seed=43)
    band = lambda t: t[:, :hq].contiguous()  # noqa: E731
    qb, kb, vb, ob, lseb, doutb = (band(t) for t in (q, k, v, o, lse, dout))
    scale = d ** -0.5
    got = streaming_attention(qb, kb, vb, **kw)
    got_lse = streaming_attention_lse(qb, kb, vb, **kw)[1]
    grads = streaming_attention_bwd(qb, kb, vb, ob, lseb, doutb, scale=scale,
                                    **kw)
    whole = streaming_attention(q, k, v, **kw)
    whole_grads = streaming_attention_bwd(q, k, v, o, lse, dout, scale=scale,
                                          **kw)
    same = (torch.equal(got, band(whole)) and torch.equal(got_lse, lseb)
            and all(torch.equal(a, band(w))
                    for a, w in zip(grads, whole_grads)))
    fwd_ulps = bf16_ulps(got, attention_ref(qb, kb, vb, **kw))
    want = attention_bwd_ref(qb, kb, vb, ob, lseb, doutb, scale=scale, **kw)
    bwd_err = {n: float((a.float() - w.float()).abs().max()
                        / w.float().abs().max())
               for n, a, w in zip(("dq", "dk", "dv"), grads, want)}
    torch.cuda.synchronize()
    log(f"[tp train band] #3 and its backward at {hq} of {hq * TP_RANKS} "
        f"heads ({shape}, {kw}, bf16): the band's output, lse and gradients "
        f"bit-equal to the same heads of the {hq * TP_RANKS}-head launch: "
        f"{same}; forward vs plain {fwd_ulps:.2f} bf16 ulps beyond the f32 "
        f"atol (limit 1); backward vs plain max|Δ| / max|plain| "
        + ", ".join(f"{n} {e:.3g}" for n, e in bwd_err.items())
        + f" (limit {BWD_TOL['bfloat16']:.3g}); {CARD[0]}")
    if not same:
        fail("tp train band: #3 at the head band differs from the same "
             "heads of the full launch")
    if fwd_ulps > 1.0:
        fail(f"tp train band: #3 forward {fwd_ulps} bf16 ulps from plain")
    if max(bwd_err.values()) > BWD_TOL["bfloat16"]:
        fail(f"tp train band: #3 backward {bwd_err} over "
             f"{BWD_TOL['bfloat16']}")
    device_ms = cuda_ms(lambda: streaming_attention(qb, kb, vb, **kw),
                        flush=flush, spin=True)
    del q, k, v, o, lse, dout, qb, kb, vb, ob, lseb, doutb, got, grads
    del whole, whole_grads, want
    torch.cuda.empty_cache()
    fwd = dict(time_streaming_calls([TP_BAND], flush, seed=43)[label],
               device_ms=device_ms)
    log(f"[time] streaming_attention {label}: device alone {device_ms:.4f} "
        f"ms; {CARD[0]}")
    bwd = time_streaming_bwd(flush, {}, cases=[TP_BAND])["shapes"][label]
    return dict(label=label, bit_equal_full_launch=same,
                forward_bf16_ulps=fwd_ulps, backward_rel_err=bwd_err,
                forward=fwd, backward=bwd)


def tp_train_config():
    """(model config, data config, train config) of phase 18: phase 16's
    deepseek-7b cut, its shape, moments and 6-step schedule."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig
    from repro_torch.runtime import TrainConfig
    cfg = get_config(MODEL).replace(num_layers=TP_TRAIN_LAYERS)
    batch, seq = TP_TRAIN_SHAPE
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=batch, corpus="lm")
    tcfg = TrainConfig(steps=TP_TRAIN_TOTAL, ckpt_every=10 ** 6,
                       keep_ckpts=1, moment_dtype="bfloat16")
    return cfg, dcfg, tcfg


def tp_train_rank(ckpt_dir):
    """One rank of phase 18 (``launch.mesh.spawn``, a gloo group of
    ``TP_RANKS`` on this card): ``Trainer(mesh=Mesh((1, TP_RANKS)))``
    draws phase 16's seeded deepseek-7b cut and runs ``TP_TRAIN_STEPS``
    steps (the main path; the run's end writes the checkpoint: rank 0
    from the gathered blocks), then ``compressed_psum`` of seeded card
    tensors, then ``pipeline_apply`` over the ranks (2 stages of the
    trained weights' layers) against the same layers in sequence on every
    microbatch → facts of this rank."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.device import configure_matmul_precision
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.lm import layer_keys, trunk_apply
    from repro_torch.parallel import (collectives, compressed_psum,
                                      pipeline_apply, stack_stages)
    from repro_torch.parallel.sharding import gather_tree
    from repro_torch.runtime import Trainer
    rank = dist.get_rank()
    t_start = time.perf_counter()
    cfg, dcfg, tcfg = tp_train_config()
    mesh = Mesh((1, TP_RANKS), ("data", "model"))
    tr = Trainer(cfg, dcfg, dataclasses.replace(tcfg, ckpt_dir=ckpt_dir),
                 mesh=mesh, device=DEV)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_training_counts()
    collectives.reset_traffic()
    t0 = time.perf_counter()
    metrics = tr.run(num_steps=TP_TRAIN_STEPS)               # the main path
    torch.cuda.synchronize()
    facts = dict(rank=rank, run_s=time.perf_counter() - t0,
                 launches=read_training_counts(),
                 traffic=dict(collectives.TRAFFIC),
                 peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                 losses=[m["loss"] for m in metrics],
                 grad_norms=[m["grad_norm"] for m in metrics],
                 lrs=[m["lr"] for m in metrics],
                 steps=[m["step"] for m in metrics],
                 step_ms=[m["ms"] for m in metrics],
                 block_shapes={k: list(v.shape) for k, v in tr.params.items()
                               if k in ("embed", "wq", "wo", "up", "down")})
    facts["step_ms_p50"] = float(np.percentile(facts["step_ms"][1:], 50))
    layers = {k: v for k, v in gather_tree(tr.params, tr.specs, mesh).items()
              if k in layer_keys(cfg)}
    del tr, metrics
    torch.cuda.empty_cache()
    # compressed_psum: bf16 on the wire, the sum widened
    g = torch.Generator(device=DEV).manual_seed(18)
    ab = [torch.randn(TP_PSUM_SHAPE, generator=g, device=DEV) * 10
          for _ in range(TP_RANKS)]
    summed = compressed_psum({"g": ab[rank]}, mesh.axis("model"))["g"]
    want = ab[0].to(torch.bfloat16)
    for x in ab[1:]:
        want = want + x.to(torch.bfloat16)
    facts["psum_bit_equal"] = bool(summed.dtype == torch.float32
                                   and torch.equal(summed, want.float()))
    # the pipeline: stage s holds layers [s·L/S, (s+1)·L/S) of the trained
    # weights; microbatches of seeded activations
    pipe = Mesh((TP_RANKS,), ("pod",))
    per = cfg.replace(num_layers=TP_TRAIN_LAYERS // TP_RANKS)
    pos = torch.arange(TP_TRAIN_SHAPE[1], dtype=torch.int32, device=DEV)
    configure_matmul_precision()
    x = (torch.randn((TP_PIPE_M, TP_PIPE_MB, TP_TRAIN_SHAPE[1], cfg.d_model),
                     generator=g, device=DEV)).to(torch.bfloat16)
    stages = stack_stages(layers, TP_RANKS)
    collectives.reset_traffic()
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pipeline_apply(lambda p, h: trunk_apply(per, p, h, pos=pos)[0],
                             stages, x, pipe, axis="pod")
        torch.cuda.synchronize()
        facts["pipeline_ms"] = (time.perf_counter() - t0) * 1e3
        facts["pipeline_traffic"] = dict(collectives.TRAFFIC)
        t0 = time.perf_counter()
        seq = torch.stack([trunk_apply(cfg, layers, x[m], pos=pos)[0]
                           for m in range(TP_PIPE_M)])
        torch.cuda.synchronize()
        facts["sequential_ms"] = (time.perf_counter() - t0) * 1e3
    facts["pipeline_bit_equal"] = bool(torch.equal(out, seq))
    facts["pipeline_max_gap"] = float((out.float() - seq.float()).abs().max())
    facts["pipeline_finite"] = bool(torch.isfinite(out).all())
    facts["rank_s"] = time.perf_counter() - t_start
    return facts


def phase_tp_training(p16):
    """Phase 18 (see the module docstring): ``p16`` is phase 16's
    deepseek-7b facts, whose single-device losses and gradient norms the
    mesh run is held to → its facts."""
    import dataclasses
    import tempfile
    import torch
    from repro_torch.launch.mesh import spawn
    from repro_torch.runtime import Trainer
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=DEV)
    band = tp_band_attention(lambda: flush_buf.zero_())
    del flush_buf
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    log(f"[tp train] {CARD[0]}; before spawning {TP_RANKS} ranks: "
        f"{free / 2 ** 30:.1f} of {total / 2 ** 30:.1f} GiB free on the card")
    cfg, dcfg, tcfg = tp_train_config()
    want_loss, want_norm = p16["losses"], p16["grad_norms"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_train_") as tmp:
        t_spawn = time.perf_counter()
        ranks = spawn(tp_train_rank, TP_RANKS, tmp, timeout=TP_TIMEOUT_S)
        spawn_s = time.perf_counter() - t_spawn
        checkpoints = sorted(os.listdir(tmp))
        # one device resumes the mesh's checkpoint for one more step
        t_one = time.perf_counter()
        one = Trainer(cfg, dcfg, dataclasses.replace(tcfg, ckpt_dir=tmp),
                      device=DEV)
        restored = one.restore()
        one.ckpt = None                  # continue without writing again
        reset_training_counts()
        after = one.run(num_steps=1)
        one_counts = read_training_counts()
        del one
        torch.cuda.empty_cache()
        resume_s = time.perf_counter() - t_one
    lead = ranks[0]
    label = f"tp train mesh (1, {TP_RANKS})"
    n = len(lead["losses"])
    if any(r_["losses"] != lead["losses"] or r_["grad_norms"] !=
           lead["grad_norms"] for r_ in ranks):
        fail(f"{label}: the ranks logged different losses or norms")
    if lead["steps"] != list(range(TP_TRAIN_STEPS)) or \
            checkpoints != [f"step_{TP_TRAIN_STEPS:08d}"] or \
            restored != TP_TRAIN_STEPS:
        fail(f"{label}: steps {lead['steps']}, checkpoints {checkpoints}, "
             f"restored {restored}")
    if lead["losses"][0] != want_loss[0]:
        fail(f"{label}: step 0 loss {lead['losses'][0]!r} is not phase 16's "
             f"single-device {want_loss[0]!r}")
    held = dict(loss=[], grad_norm=[])
    got = dict(loss=lead["losses"] + [after[0]["loss"]],
               grad_norm=lead["grad_norms"] + [after[0]["grad_norm"]])
    want = dict(loss=want_loss[:n + 1], grad_norm=want_norm[:n + 1])
    for key in held:
        for i, (a, w) in enumerate(zip(got[key], want[key])):
            rel = abs(a - w) / abs(w)
            held[key].append(rel)
            if rel > TP_TRAIN_RTOL:
                fail(f"{label}: step {i} {key} {a!r} vs phase 16's {w!r}: "
                     f"{rel:.3g} over {TP_TRAIN_RTOL}")
    per_step = attention_calls(cfg)
    for r_, f in enumerate(ranks):
        c = f["launches"]
        if c["fwd"] != per_step * n or c["bwd"] != per_step * n or \
                c["bwd_by_variant"]["tensor_core"] != per_step * n:
            fail(f"{label} rank {r_}: #3 forward {c['fwd']} and backward "
                 f"{c['bwd']} launches (by variant {c['bwd_by_variant']}), "
                 f"expected attention calls × steps = {per_step} × {n} at "
                 f"the band")
        if not f["psum_bit_equal"]:
            fail(f"{label} rank {r_}: compressed_psum is not bf16(a) + "
                 f"bf16(b) widened")
        if not (f["pipeline_bit_equal"] and f["pipeline_finite"]):
            fail(f"{label} rank {r_}: the pipeline's outputs differ from the "
                 f"sequential forward by {f['pipeline_max_gap']}")
    if one_counts["fwd"] != per_step or one_counts["bwd"] != per_step:
        fail(f"{label}: the single-device step launched #3 {one_counts}")
    phase_s = time.perf_counter() - t0
    facts = dict(band=band, spawn_s=spawn_s, resume_s=resume_s,
                 phase_s=phase_s, checkpoints=checkpoints,
                 losses=got["loss"], grad_norms=got["grad_norm"],
                 phase16_losses=want["loss"],
                 phase16_grad_norms=want["grad_norm"], rel_err=held,
                 limit=TP_TRAIN_RTOL,
                 launches=[f["launches"] for f in ranks],
                 ranks=[{k: v for k, v in f.items() if k != "launches"}
                        for f in ranks])
    bit_equal = [a == w for a, w in zip(got["loss"], want["loss"])]
    log(f"[{label}] deepseek-7b cut to {cfg.num_layers} layers, "
        f"{TP_TRAIN_SHAPE[0]} × {TP_TRAIN_SHAPE[1]} tokens, bf16 moments, "
        f"{n} steps through Trainer(mesh=...).run() in {TP_RANKS} gloo ranks "
        f"(blocks on rank 0 {lead['block_shapes']}), then step {n} on one "
        f"device from the mesh's checkpoint {checkpoints}: losses "
        f"{got['loss']} (phase 16's {want['loss']}; bit-equal "
        f"{bit_equal}), grad norms {got['grad_norm']} (phase 16's "
        f"{want['grad_norm']}); relative gaps {held} (limit "
        f"{TP_TRAIN_RTOL}); mesh step ms p50 {lead['step_ms_p50']:.1f} "
        f"(rank 1 {ranks[1]['step_ms_p50']:.1f}; phase 16's single device "
        f"{p16['step_ms_p50']:.1f}); #3 forward / backward launches a rank "
        f"{[(f['launches']['fwd'], f['launches']['bwd']) for f in ranks]} = "
        f"{per_step} × {n} at {TP_BAND[1][1]} heads; collectives a rank "
        + json.dumps([f["traffic"] for f in ranks])
        + f"; peak {[round(f['peak_gib'], 2) for f in ranks]} GiB a rank; "
        f"the run {[round(f['run_s'], 1) for f in ranks]} s a rank (its "
        f"end's save included); {CARD[0]}")
    log(f"[{label}] compressed_psum of {TP_PSUM_SHAPE} f32 card tensors = "
        f"bf16(a) + bf16(b) widened, bit for bit on every rank; "
        f"pipeline_apply over {TP_RANKS} stages of "
        f"{TP_TRAIN_LAYERS // TP_RANKS} trained layers, M = {TP_PIPE_M} "
        f"microbatches of {TP_PIPE_MB} × {TP_TRAIN_SHAPE[1]}: bit-equal to "
        f"the sequential {TP_TRAIN_LAYERS}-layer forward on each "
        f"microbatch; {lead['pipeline_ms']:.1f} ms (sequential "
        f"{lead['sequential_ms']:.1f} ms), hops "
        + json.dumps(lead["pipeline_traffic"])
        + f"; spawn to join {spawn_s:.1f} s (ranks "
        f"{[round(f['rank_s'], 1) for f in ranks]} s), one-device resume "
        f"{resume_s:.1f} s; phase {phase_s:.1f} s; {CARD[0]}")
    return facts


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; nothing to run",
              file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.params import init_params
    from repro_torch.serving import EngineCore

    t_start = time.perf_counter()
    phase_s, clock = {}, [t_start]

    def mark(what):
        now = time.perf_counter()
        phase_s[what] = now - clock[0]
        clock[0] = now

    name, smi_line = phase_card()
    built = phase_build()
    mark("1-2 card, build")
    phase_lut_exp()
    lut_bwd_checks = phase_lut_exp_bwd()
    mark("3 LUT exp")
    phase_paged_attention()
    mark("4 paged attention")
    p7_steps = phase7_steps()
    tuner = phase_tuner(p7_steps)
    mark("4a tuner")
    sa_worst = phase_streaming_attention()
    mark("5 streaming attention")
    bert = phase_bert()
    mark("6 BERT")
    phase_int8_checks()
    int8_bert = phase_int8_bert()
    mark("8-9 INT8")

    cfg = get_config(MODEL)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0), DEV)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.values())
    log(f"[weights] {cfg.name}: {n_params / 1e9:.2f} B parameters, "
        f"{sum(p.numel() * p.element_size() for p in params.values()) / 1e9:.1f}"
        f" GB {cfg.dtype}, drawn in {time.perf_counter() - t0:.1f} s")
    rng, lens = phase7_lens()
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in lens]
    log(f"[requests] 8 prompts of {sorted(int(n) for n in lens)} tokens, "
        f"max_new {MAX_NEW}")

    facts = {"launches": {}, "eager_launches": {}}
    compiled = {}
    for kv_quant in (False, True):
        tag, pool = ("int8", "int8") if kv_quant else ("bf16", "bfloat16")
        eng, f = phase_engine(cfg, params, kv_quant, prompts)
        served = [k for k in f["kinds"] if k[2]]
        if served != p7_steps[0]:
            fail(f"engine {tag}: served steps {served}, not the "
                 f"{len(p7_steps[0])} steps the tuner weighted "
                 f"({p7_steps[0]})")
        facts[tag] = f
        facts["eager_launches"][pool] = f["launches"]
        if not kv_quant:
            steps = {"bf16": phase_step_vs_plain(cfg, params, eng.kv.pool,
                                                 "bf16", floor=1e-2)}
        del eng
        torch.cuda.empty_cache()
        compiled[tag] = phase_compiled(cfg, params, kv_quant, prompts, f)
        # the main path: the engine as a user builds it, capture on
        facts["launches"][pool] = compiled[tag]["launches"]
        if not kv_quant:
            arms = phase_config_arms(cfg, params, prompts)
    mark("7 deepseek engine")
    prefix = {tag: phase_prefix(cfg, params, kv_quant)
              for tag, kv_quant in (("bf16", False), ("int8", True))}
    greedy_streams = {tag: compiled[tag].pop("streams")
                      for tag in ("bf16", "int8")}
    mark("7a prefix cache")
    spec = phase_spec(cfg, params, prompts, greedy_streams["bf16"],
                      compiled["bf16"])
    mark("7b speculation")
    sampled, sampled_streams = {}, {}
    for tag, kv_quant in (("bf16", False), ("int8", True)):
        f, eng = phase_sampled(cfg, params, kv_quant, prompts,
                               greedy_streams[tag], compiled[tag])
        if tag == "bf16":
            door = phase_front_door(eng, prompts, f["streams"])
        sampled_streams[tag] = f.pop("streams")
        sampled[tag] = f
        del eng
        torch.cuda.empty_cache()
    mark("7c-7d sampling, front door")
    ckpt = phase_checkpoint(cfg, params, prompts)
    mark("7e checkpoint")
    padded = phase_padded(cfg, params, prompts, greedy_streams, compiled)
    mark("7f padded oracle")
    slot = {}
    for tag, kv_quant in (("bf16", False), ("int8", True)):
        c = cfg.replace(kv_quant=kv_quant)
        slot[tag] = phase_slot_engine(
            cfg, params, kv_quant, prompts,
            dict(enumerate(greedy_streams[tag])),
            lambda c=c: EngineCore(c, params, device=DEV, **ENGINE),
            SLOT_ENGINES[MODEL], f"slot {MODEL} {tag}")
    mark("12 slot engine deepseek bf16, int8")
    facts["paths"] = {"prefix bf16": prefix["bf16"]["launches"],
                      "prefix int8": prefix["int8"]["launches"],
                      "spec (a)": spec["scripted"]["launches"],
                      "sampled bf16": sampled["bf16"]["launches"],
                      "sampled int8": sampled["int8"]["launches"],
                      "padded bf16": padded["bf16"]["launches"],
                      "padded int8": padded["int8"]["launches"]}
    facts["sampled"] = sampled
    scoring = {"bf16": phase_scoring(cfg, params, "bf16", floor=1e-2)}
    steps["f32"] = phase_step_f32(cfg, params)       # widens params to f32
    scoring["f32"] = phase_scoring(cfg.replace(dtype="float32"), params,
                                   "f32", floor=1e-3)
    # phase 12 in f32 (the weights are widened now): the slot engine
    # against EngineCore where bf16's random-weight near-ties do not reach
    c32 = cfg.replace(dtype="float32")
    make32 = lambda: EngineCore(c32, params, device=DEV, **ENGINE)  # noqa: E731
    wave = [[(i, p) for i, p in enumerate(prompts)]]
    want32 = fresh_run(make32, lambda e, t: serve_waves(e, wave))(
        frozenset())["streams"]
    slot["f32"] = phase_slot_engine(c32, params, False, prompts, want32,
                                    make32, SLOT_ENGINES[MODEL],
                                    f"slot {MODEL} f32", lockstep=False)
    del params
    torch.cuda.empty_cache()
    mark("7 scoring, f32 step, 12 slot f32")
    facts["decode_kv_lens"] = decode_kv_lens()
    facts["bert"], facts["scoring"] = bert, scoring
    facts["int8_bert"] = int8_bert
    facts["build"] = built
    facts["lut_exp_bwd"] = lut_bwd_checks
    kernels = phase_timing(facts, cfg.vocab_size)
    kernels[0]["tuner"] = {
        tag: {k: t[k] for k in ("winner", "winner_ms", "default_ms",
                                "predicted_winner", "spearman")}
        for tag, t in tuner.items()}
    mark("10 timing")
    families = phase_families()
    mark("11 dense families")
    by_name = {k["name"]: k for k in kernels}
    by_name["paged_combine"].setdefault("launches_by_path", {}).update({
        f"padded {tag}": padded[tag]["launches"]["paged_combine"]
        for tag in ("bf16", "int8")})
    by_name["paged_attention"]["padded_block"] = dict(
        padded["time"], launches={tag: padded[tag]["launches"]
                                  ["paged_attention"]
                                  for tag in ("bf16", "int8")})
    for model, f in families.items():
        for pool in ("bf16", "int8"):
            for k in ("paged_attention", "paged_combine"):
                if pool in f:
                    by_name[k]["launches_by_path"][f"{model} {pool}"] = (
                        f[pool]["launches"][k])
        if "sampled" in f["bf16"]:
            by_name["lut_exp"]["launches_by_path"][f"{model} sampled bf16"] = (
                f["bf16"]["sampled"]["launches"]["lut_exp"])
        by_name["paged_attention"]["families"][model] = {
            k: f[k] for k in ("time_decode", "time_mixed") if k in f}
        sa = by_name["streaming_attention"].setdefault("launches_by_path", {})
        sa[f"scoring {model}"] = f["scoring"]["launches"]
        if "slot" in f:
            sa[f"slot engine {model} bf16"] = (
                f["slot"]["launches"]["streaming_attention"])
    for tag, f in slot.items():
        by_name["streaming_attention"]["launches_by_path"][
            f"slot engine {MODEL} {tag}"] = f["launches"]["streaming_attention"]
    moe = phase_moe()
    by_name["lut_exp"]["router"] = {}
    for model, f in moe.items():
        for pool in ("bf16", "int8"):
            if pool not in f:
                continue
            for k in ("paged_attention", "paged_combine"):
                by_name[k]["launches_by_path"][f"{model} {pool}"] = (
                    f[pool]["launches"][k])
            by_name["lut_exp"]["launches_by_path"][
                f"{model} {pool} router"] = f[pool]["launches"]["lut_exp"]
        by_name["paged_attention"]["families"][model] = {
            "time_decode": f["time_decode"]}
        by_name["lut_exp"]["router"][model] = f["time_router_exp"]
        sa = by_name["streaming_attention"]["launches_by_path"]
        sa[f"scoring {model}"] = f["scoring"]["launches"]
        sa[f"scoring {model} f32"] = f["scoring_f32"]["launches"]
    mark("13 MoE family")
    ssm = phase_ssm()
    for model, f in ssm.items():
        la = f["slot"]["launches"]
        by_name["lut_exp"]["launches_by_path"][f"slot engine {model} bf16"] = (
            la["lut_exp"])
        if la["streaming_attention"]:
            by_name["streaming_attention"]["launches_by_path"][
                f"slot engine {model} bf16"] = la["streaming_attention"]
    mark("14 SSM families")
    vlm = phase_vlm()
    by_name["paged_attention"]["launches_by_path"][f"{VLM_MODEL} bf16"] = (
        vlm["bf16"]["launches"]["paged_attention"])
    by_name["paged_combine"]["launches_by_path"][f"{VLM_MODEL} bf16"] = (
        vlm["bf16"]["launches"]["paged_combine"])
    by_name["lut_exp"]["launches_by_path"][f"{VLM_MODEL} sampled bf16"] = (
        vlm["bf16"]["sampled"]["launches"]["lut_exp"])
    sa = by_name["streaming_attention"]["launches_by_path"]
    sa[f"multimodal prefill {VLM_MODEL}"] = vlm["multimodal"]["launches"]
    encdec = phase_encdec()
    sa[f"prefill {ENCDEC_MODEL}"] = encdec["generate"]["launches_per_prefill"]
    sa[f"scoring {ENCDEC_MODEL}"] = encdec["scoring"]["launches"]
    mark("15 vlm, encdec")
    bwd_checks = phase_backward_checks()
    training = phase_training()
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=DEV)
    bwd = time_streaming_bwd(
        lambda: flush_buf.zero_(),
        {f"training {m}": f["launches"]["bwd"] for m, f in training.items()})
    del flush_buf
    bwd["max_abs_err"] = max(bwd_checks[f"{BWD_SHAPES[0][0]} bfloat16"][
        "abs_err"].values())
    kernels.append(bwd)
    for model, f in training.items():
        sa[f"training {model}"] = f["launches"]["fwd"]
        if f["launches"]["lut_exp"]:
            by_name["lut_exp"]["launches_by_path"][f"training {model}"] = (
                f["launches"]["lut_exp"])
    lut_bwd = by_name["lut_exp_bwd"]
    lut_bwd["launches_by_path"] = {
        f"training {m}": f["launches"]["lut_exp_bwd"]
        for m, f in training.items() if f["launches"]["lut_exp_bwd"]}
    lut_bwd["launches"] = sum(lut_bwd["launches_by_path"].values())
    if not lut_bwd["launches"]:
        fail("phase 16 launched #1's backward kernel no time")
    mark("16 training")
    tp = phase_tp_serving(prompts, sampled_streams)
    for tag in ("bf16", "int8"):
        for r_, n in tp["launches"][tag].items():
            for k in ("paged_attention", "paged_combine"):
                by_name[k]["launches_by_path"][
                    f"mesh {TP_RANKS} {tag} {r_}"] = n[k]
            by_name["lut_exp"]["launches_by_path"][
                f"mesh {TP_RANKS} sampled {tag} {r_}"] = n["lut_exp"]
    by_name["paged_attention"]["families"][
        f"{MODEL} band (mesh {TP_RANKS})"] = tp["band"]
    mark("17 tensor-parallel serving")
    tpt = phase_tp_training(training[MODEL])
    sa = by_name["streaming_attention"]["launches_by_path"]
    for r_, n in enumerate(tpt["launches"]):
        path = f"training {MODEL} mesh (1, {TP_RANKS}) rank {r_}"
        sa[path] = n["fwd"]
        bwd["launches_by_path"][path] = n["bwd"]
    bwd["launches"] = sum(bwd["launches_by_path"].values())
    by_name["streaming_attention"]["band"] = tpt["band"]["forward"]
    bwd["band"] = dict(tpt["band"]["backward"],
                       rel_err=tpt["band"]["backward_rel_err"])
    mark("18 tensor-parallel training, pipeline")

    summary = {k: {kk: vv for kk, vv in facts[k].items()
                   if kk not in ("streams", "kinds")} for k in ("bf16", "int8")}
    summary["compiled"] = compiled
    summary["prefix"] = prefix
    summary["spec"] = spec
    summary["sampled"] = sampled
    summary["front_door"] = door
    summary["tuner"] = tuner
    summary["config_arms"] = arms
    summary["checkpoint"] = ckpt
    summary["padded"] = padded
    summary["slot_engine"] = slot
    summary["step_vs_plain"] = steps
    summary["streaming_attention_checks"] = sa_worst
    summary["bert"] = bert
    summary["scoring"] = scoring
    summary["int8_bert"] = int8_bert
    summary["families"] = families
    summary["moe"] = moe
    summary["ssm"] = ssm
    summary["vlm"] = vlm
    summary["encdec"] = encdec
    summary["backward_checks"] = bwd_checks
    summary["lut_exp_backward_checks"] = lut_bwd_checks
    summary["training"] = training
    summary["tp_serving"] = tp
    summary["tp_training"] = tpt
    summary["phase_s"] = phase_s
    log("[summary] " + json.dumps(summary))
    log("[phases] seconds " + json.dumps({k: round(v, 1)
                                          for k, v in phase_s.items()}))
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
