#!/usr/bin/env python3
"""Card check of the PyTorch/CUDA port (vnsum_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising on failure (so any failure exits non-zero):

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions; TF32 is switched off for matmul and cuDNN;
2. build: every kernel of ``vnsum_tpu_torch/ops/csrc`` compiled with nvcc
   for sm_90a, timed, with each kernel function's registers and spills
   (ptxas) and the kernels' dynamic shared memory;
3. correctness: each kernel against its plain PyTorch version on the card,
   at the stated limits (TOLERANCES below), over bf16 and int8 caches,
   query offsets, windows, left pads with a row that sees no key, a layer
   other than 0, a fill short of the cache; at the pipeline's own batches
   (map B=8 S=4096 C=4224, decode fills 4096 and 4223; reduce B=8 S=512
   C=640) and K1 and K2 at every other batch the strategies phase may
   run (B = 1, 2, 4 and 8 by S = 512, 1024, 2048 and 4096, C = S + 128,
   fills S and C-1, bf16 and int8, ragged pads and an all-pad filler
   row: phase 7 fails on a batch outside them); K1 and K2 at the G-Eval
   judge's batches (B = 2 and 8 by S = 1024 and 2048, JUDGE_SHAPES): K1 at
   C = S for score_choices, K1 and K2 (fills S and C-1) at C = S + 256 for
   the free-decode judge, bf16 and int8, ragged pads, two all-pad filler
   rows at B = 8 (phase 7b fails on a batch outside them); K1 at the
   prefix cache's resume shapes (B=8, S=4096, C=4224, Sq = S - K queries at
   q_offset K = 512, 2048 and 3584 over seeded slots [0, K), bf16 and
   int8, rows starting before and after K and an all-pad filler row; and at
   head_dim 256 with Gemma3's window at K = 3584); the verify kernel at the spec path's shape (B=8, Sq=9,
   C=4096+128+9, ragged fills on both sides of a split boundary, a row
   parked at the budget, a row whose pad hides every key from its first
   queries, a window) and at the slot segment's (B=8, Sq=1, C=4224, a
   fill per row, a free row and a row parked at limit C); the last layer
   of a long-bucket cache, whose offsets pass 2^31; and the decode
   partials (K2p) at the long path's shape (B=2, C=32768, fill C-1, bf16
   and int8, layers 0 and 27 of 28, pads 0 and 12000 and a row whose pad
   is C, which must come out exactly m = -1e30, l = 0, o = 0), with o, m
   and l each held to its own limit and o / l to K2's output; K1, K2 and
   K2p at G=2 (Qwen3-0.6B) and G=8 (the decode kernels' largest); K1 and K2
   at head_dim 256 (Gemma3-4B: KV=4, G=2) at the Gemma3 phase's batches
   (GEMMA_SHAPES: map B=8 S=4096 and reduce B=8 S=512, C = S + 128), window
   0 and 1024, bf16 and int8, K2 at fills whose window floor falls inside a
   512-slot split (S, C - 1, 1500; 1500's inside a K1 tile too); K3 at
   head_dim 256 at every shape Gemma3's spec path and slot loop send
   (gemma_verify_cases: the spec step's map and reduce batches, Sq=9,
   C = S + 73; the slot segment, Sq=1, C = 4160), window 0 and 1024,
   bf16 and int8 (the reduce batch's int8 only), window floors inside a
   512-slot split and on its boundary, a parked row, a row whose pad hides
   every key from its first queries and an all-pad filler row; K1 at 256
   over those spec caches, at the slot loop's join groups (B = 1, 2, 4
   at S = 4096, C = 4160) and, with K2, at the spec backend's one-shot
   batches (B = 8, C = S + 64, int8); K1 over
   the spec path's int8 cache (C=4233, whose scale rows TMA cannot
   address); K2 and K2p with the fill as an int32 tensor on the device (one
   past the cache, which the kernel clamps); and the prefill kernel at path (c)'s prefill (B=2, S = C =
   32768, q_offset 0, bf16, the pads of its two prompts, layers 0 and 27 of
   28), run over the whole sequence and held to its plain version on four
   512-query slices (its first 512 queries see no key and must be 0);
   [int8] (a): the int8-weight GEMV at every int8 matmul shape of
   Llama-3.2-3B (wq/wo 3072 x 3072, wk/wv 1024 x 3072, w_gate/w_up 8192 x
   3072, w_down 3072 x 8192, the tied head 128256 x 3072 in head mode) and
   at its two grouped launches (q/k/v: 3072 + 1024 + 1024 channels;
   gate/up: 8192 + 8192) at M = 1, 2, 8 and 72 rows, against its plain
   version and a float64 reckoning of the same formula (GEMV_RTOL), and
   one case run twice that must give the same bits; at GQA group 4 (phases
   6b and 6c): K1 and K2 at Phi-4-14B's (KV=10) and Qwen3-8B's (KV=8) map
   and reduce batches (GEMMA_SHAPES at C = S + FAMILY_NEW, int8, and bf16
   for Phi-4, the pipeline's pads and an all-pad filler row), K3 at every
   shape Phi-4's spec path and one-step gate send (phi4_verify_cases: Sq=9,
   36 rows a block in two row halves, fills across a split boundary, a
   parked row, a row whose pad hides every key from its first queries and
   the filler row; Sq=1, 4 rows) with K1 over the same int8 caches, and the
   GEMV at every Phi-4-14B shape (PHI4_GEMV_SHAPES: wo 5120 x 5120, w_down
   5120 x 17920, the untied head 100352 x 5120; PHI4_GEMV_GROUPS: q/k/v
   5120 + 1280 + 1280, gate/up 17920 + 17920) at the same four row counts;
   [int8] (b), after phase 3:
   W8A8's s8 x s8 product (torch._int_mm) at a prefill's shape equals the
   CPU's int32 product bit for bit;
4. planted faults: each kernel rebuilt, in a temporary copy of the package,
   with one cache slot per split or tile left out (flash_decode.cu and K3
   have two more: the merge of the splits leaving out the fill's split, and
   the in-block merge leaving out the last warp's share of o; K1 one: its
   consumers reading the ring stage that TMA did not fill; the GEMV: a
   neighbouring channel's scale, the last 16 bytes of K dropped, its
   consumers reading the next stage of the ring), must fail
   every case of that kernel in phase 3 and no other, so the limits are
   shown to be tight enough to see such a fault. K2 and K2p are the two
   modes of one source and share both its passes, so the two count as one
   family, and each of its faults must fail every K2 and K2p case; every K1,
   K2 and K3 fault sits in code the head_dim-256 kernels run too, and must
   fail their cases as well;
5. timing at the main path's shapes (Llama-3.2-3B: L=28, H=24, KV=8,
   hd=128; prefill B=8 S=4096 C=4224, decode B=8 C=4224 fill=4200; verify
   B=8 Sq=9 C=4233 and B=8 Sq=1 C=4224; K1 at the prefix cache's resume
   shape, Sq=512 at q_offset 3584, C=4224): the kernel, the bound (bytes over
   3.35 TB/s or FLOP over the peak rate of the unit that does them, from
   this run's inputs; K2's, K2p's and K3's products on bf16 tensor cores,
   PV counted twice for its hi/lo halves), the two passes of K2, K2p and
   K3 apart (torch.profiler), the plain version, and one PyTorch library
   call computing the
   same function (scaled_dot_product_attention with an explicit mask on a
   bf16 cache; timed here only, never used by the port); one output of
   each is held against the other as in phase 3; the prefill kernel
   alone at the pipeline's default long bucket (S=15360, C=16384); and K2p
   at the long path's shape (B=2, C=32768, bf16 and int8), whose library
   call is scaled_dot_product_attention on the same cache expanded to 24
   heads, computing the normalised output (no public torch call returns
   the partials); [int8] (e): the GEMV at each shape of phase 3 (the
   single weights and the two grouped launches) at M = 1, 2, 8 and 72, 28
   layers of weights in turn, from CUDA graph replays: kernel, bound (its
   int8 weights and scales at 3.35 TB/s), the library calls
   (torch.matmul against the same weights in bf16, what the bf16 model
   pays, and torch._weight_int8pack_mm where the installed torch runs it
   on the card) and, at M = 8, the plain version; the kernels line takes
   one decode step's 113 calls at M = 8; K1 and K2 at head_dim 256 at
   Gemma3-4B's map batch (B=8, S=4096, C=4224, KV=4, G=2, int8 cache of 34
   layers, K2 at fill 4200) on a global layer and a sliding one (window
   1024): kernel, bound, plain version and the library call on a bf16
   copy with the windowed mask, K/V expanded to 8 heads; K3 at head_dim 256
   at Gemma3-4B's slot segment (B=8, Sq=1, C=4160) and spec step (B=8,
   Sq=9, C=4169), each on a global and a sliding layer, the same four
   numbers; at GQA group 4, the same four numbers for K1 and K2 at Phi-4's
   map batch (B=8, S=4096, C=4160, KV=10, int8 cache of 8 layers) and K3 at
   its spec step (Sq=9: 36 rows, C=4169) and its one-step gate's shape
   (Sq=1: 4 rows, C=4224), and the GEMV at Phi-4's shapes at M = 8 (8
   layers of weights in turn), summed over a decode step's 161 launches;
6. pipeline: the port's CLI runs map-reduce over data/vi_eval with
   Llama-3.2-3B at full width and depth (random bf16 weights from a seed),
   its greedy decode steps replayed as captured CUDA graphs: every document
   must succeed, every summary be written, ROUGE be computed, the kernel
   launch counters move by at least one launch per layer per prefill
   forward and by exactly one K2 launch per layer per decode step, replays
   included, and the replays plus one step per captured group be all the
   decode steps; then the same run through PipelineRunner on a backend
   built with cuda_graphs=False (every step eager) must write
   byte-identical summaries; [int8] (c) and (d): the same with --quantize
   and with --quantize --quantize-act (W8A8 prefill), the weights quantized
   on the card, the model cut to INT8_LAYERS = 7 of its 28 layers: K1 = 7 x
   prefill forwards, K2 = 7 x decode steps and GEMV launches = 29 x decode
   steps (q/k/v, wo, gate/up and w_down a layer, and the head) + one per
   prefill forward (its head; and 28 more where B x S <= 128 without
   W8A8) exactly, K2p = K3 = 0, and
   summaries byte-identical to an eager run;
6a. gemma3: the CLI's map-reduce over data/vi_eval with --models gemma3-4b
   (Gemma3-4B at its published width, cut to GEMMA_LAYERS = 12 of its 34
   layers (its globals at 5 and 11) to keep the run under 600 s: dim 2560,
   8/4 heads, head_dim 256, vocab 262,208, tied head, a 1024-slot window on
   the layers where (i + 1) % 6 != 0; random bf16 weights from seed 0, byte
   tokenizer, int8 KV cache, greedy), decode steps captured: every document
   ok, ROUGE and the embedding metrics computed, K1 = 12 x prefill
   forwards and K2 = 12 x decode steps exactly, K2p = K3 = GEMV = 0, every
   batch one of phase 3's GEMMA_SHAPES; an eager control through
   PipelineRunner byte-identical; then the map batch's last-position logits
   through K1 (int8 and bf16 cache) against the dense windowed forward on a
   bf16 cache within LOGITS_GATE_RTOL of the largest |logit|, with every
   layer run global as a planted fault that must exceed it; K2p must raise
   NotImplementedError naming ROADMAP B4 at head_dim 256, launching
   nothing; then on the same model path (a) (map-reduce through
   PipelineRunner with spec_k=8 and the oracle run, whose references are
   the one-shot's generated ids decoded unstripped, which must accept
   drafts), the one-step K3-against-K2 gate (STEP_KERNEL_RTOL) and path
   (b) (the slot loop over the map prompts in two waves at fused_segments
   4), at GEMMA_PATH_NEW new tokens, each with K1, K2 and K3 launches
   exactly 12 x the engine record's prefill forwards, decode steps and
   verify steps; wall, prefill and decode seconds and steps, peak memory
   on ``[gemma3]`` lines, the paths on ``[gemma3 spec]`` and ``[gemma3
   slot]`` lines;
6b. phi4: Phi-4-14B at its published width and depth (40 layers, dim 5120,
   40/10 heads: GQA group 4, head_dim 128, intermediate 17,920, vocab
   100,352, untied head; random bf16 weights from seed 0, byte tokenizer,
   FAMILY_NEW = 64 new tokens): the CLI's map-reduce with --models
   phi4:14b, decode steps captured, and an eager control byte-identical to
   it, K1 = 40 x prefill forwards and K2 = 40 x decode steps exactly, K2p
   = K3 = GEMV = 0, every batch one phase 3 checked; the dense logits gate
   (a row at a time) within LOGITS_GATE_RTOL, its planted fault (every
   row's first 512 keys left out) over it; one captured decode step
   profiled; path (a) on the same model (spec_path and its oracle, K3 at
   36 rows on every layer, counts exact) and the one-step K3-against-K2
   gate; then, with that model freed, the CLI's map-reduce with
   --quantize (the engine quantizes its bf16 init, as the JAX engine
   does), GEMV launches = gemv_need exactly, every document ok; then a
   2-layer Phi-4 at full width written in the fused Phi-3 layout
   (write_phi_checkpoint: qkv_proj, gate_up_proj, model_type phi3) and
   loaded with load_hf_checkpoint, its parameters and map-batch logits
   equal to the source model's bit for bit, the load's peak device and
   host memory logged;
6c. qwen3: Qwen3-8B at its published width and depth (36 layers, dim
   4096, 32/8 heads: GQA group 4, head_dim 128, QK norm, intermediate
   12,288, vocab 151,936; random bf16 weights, FAMILY_NEW new tokens): the
   CLI's map-reduce captured, K1 = 36 x prefill forwards and K2 = 36 x
   decode steps exactly, every batch one phase 3 checked, and the dense
   logits gate;
6d. weights: the pipeline phase's own weights (init_model(llama32_3b(), 0))
   written as an HF checkpoint (save_hf_checkpoint: 28 layers in four bf16
   shards, the embeddings in a fifth, and an index; into the temp dir, or
   the git-ignored chip_weights/ when the temp dir lacks room), loaded back
   with load_hf_checkpoint onto the card: the config and every parameter
   must equal the source's, one map-batch prefill forward (B=8, S=4096,
   int8 cache) must give the source's logits exactly, and map-reduce over
   data/vi_eval through PipelineRunner on TorchBackend(model=loaded,
   tokenizer="byte") must write summaries byte-identical to the pipeline
   phase's captured run, with K1 = 28 x prefill forwards and K2 = 28 x
   decode steps exactly; the write and load seconds, the free space and
   the load's peak device memory are logged, and the checkpoint is deleted
   at the end, also on failure;
6e. encoder: the eval encoder at minilm_like()'s full shape (6 layers, dim
   384, 12 heads, max_len 512), random f32 weights from seed 0, on the card
   against the same weights on the CPU: token embeddings of one [32, 512]
   batch (the data/vi_eval summaries and documents, padded with empty
   texts) within ENCODER_ATOL, and every text's BERTScore F1 against itself
   within 1e-5 of 1; then those weights written under BERT names with the
   port's safetensors writer and loaded back with load_hf_encoder: equal
   config, parameters and scores;
7. strategies: the other four approaches (mapreduce_critique, iterative,
   mapreduce_hierarchical at max_depth 2 over a tree JSON the phase writes,
   skeleton), each through PipelineRunner with the CLI's configuration
   (chunk_size 1024, 128 new tokens; critique at token_max 16, which must
   take at least one collapse round and the token_max // 2 context pass)
   on Llama-3.2-3B at full width and depth, hierarchical at full width and
   4 of its 28 layers (HIERARCHICAL_LAYERS; random bf16 weights from seed
   0), batch 8, int8 KV cache, decode steps captured: every document ok,
   ROUGE computed, K1 launches = n_layers x prefill forwards and K2
   launches = n_layers x decode steps exactly, K2p and K3 not
   launched, every batch at a (B, S) whose K1 and K2 phase 3 checked, the
   replays plus one step per captured group all the decode steps, and the
   launches logged by kernel shape; then hierarchical again
   on a backend built with cuda_graphs=False, whose summaries must be
   byte-identical;
7b. judge: the G-Eval judge on Llama-3.2-3B at full width and depth
   (random bf16 weights from seed 0, byte tokenizer, int8 KV cache, batch
   8) over the 14 judge prompts of data/vi_eval (each file's correctness
   and coherence prompt, built from the pipeline phase's summaries and
   ending in the forced prefix '\n{"score": '). (a) score_choices in one
   call and in 7 calls of two: K1 = 28 x prefill forwards exactly, K2 =
   K2p = K3 = GEMV = 0, every batch a JUDGE_SHAPES shape; the five gathered
   logits within JUDGE_LOGITS_RTOL of the largest |logit| of an
   independent dense control (flash=False, bf16 cache, B = 1, no pad), the
   picks of both runs equal to the control's wherever its top-two margin
   exceeds that limit (picks inside it counted and logged), and the choice
   ids shifted by one in the script's own call must exceed it; then the
   same on the model's int8 copy, whose GEMV launches are one head a
   prefill forward. (b) PipelineRunner(llm_judge=LLMJudge(engine,
   constrained=True)) over data/vi_eval: 7/7 successful, 0 failed, finite
   means, its summaries the pipeline phase's and its judge prompts (a)'s,
   launches exact. (c) the CLI with --judge-backend torch:llama3.2-3b (a
   second random 3B model, free decode of up to 256 new tokens, captured):
   7 cases processed, K1 and K2 launches exactly 28 x the two engines'
   prefill forwards and decode steps, summaries the pipeline phase's.
   ``[judge]`` lines log the score_choices wall a call and a prompt token,
   the prefill seconds, the wall a judged file, the peak device memory with
   the second model and the margin counts;
8. spec pipeline (path a): the same run through PipelineRunner with a
   backend built with GenerationConfig(spec_k=8), so every map and reduce
   group decodes speculatively against its references through the verify
   kernel: 7/7 documents, ROUGE, launches exactly 28 x the engine record's
   prefill forwards, verify steps and one-shot decode steps; then
   the map batch again with the one-shot run's generated ids as references,
   which must accept drafts (multi-token steps, ragged per-row fills on the
   card);
   then, gated, one verify forward of 9 tokens (K3) against 9 decode steps
   (K2) of the same tokens on the map batch, within SPEC_LOGITS_RTOL, with
   a fault planted in the script's own call that must exceed it; and one
   decode step through K3 at Sq=1 against K2 with the same GEMMs, within
   STEP_KERNEL_RTOL, with its own planted fault;
9. slot loop (path b): TorchBackend.start_slot_loop(slots=8,
   prompt_tokens=4096, max_new_tokens=128, segment_tokens=32) fed the 7 map
   prompts in two waves and drained, at fused_segments 1 and 4: every
   request completes, K1 and K3 launches exactly 28 x the join groups'
   prefill forwards and x the decode steps run;
9b. prefix cache (ROADMAP A8): TorchBackend(cache_blocks=...) on the same
   model, the map batch's prompts (built as the pipeline builds them), the
   arms of the JAX package's A/B: uncached (the cache off), cold (an empty
   512-block pool), warm (the same call: every row resumes at K = 3584, K1
   at q_offset 3584 over the gathered blocks), hinted (a fresh pool, the map
   template's header as the hint, twice), post-eviction (a 64-block pool,
   cold then warm: evictions), pipeline (map-reduce through PipelineRunner
   on the warm backend, the strategies' own hints: every document ok, the
   map call resumes). Each call's launches exactly 28 x its prefill
   forwards (K1) and decode steps (K2, captured), K2p = K3 = GEMV = 0; its
   per-prompt report, hit and miss counters and pool stats consistent, no
   pin left; the warm call's gathered slots [pad_r, K) equal the cold
   call's cache bit for bit; its last-position logits within
   RESUME_LOGITS_RTOL of the cold call's, and the resume over an unseeded
   cache (planted in the script's own call) beyond it. Then the slot loop with a
   512-block pool: 3 map prompts, drained, then the same 3, whose join
   resumes (cached tokens > 0 at K = 3584), K1 and K3 launches exact.
   ``[cache]`` lines log each arm's hit and miss tokens, prefill, gather
   and insert seconds, the pool's bytes and peak memory; agreement with the
   uncached arm is logged, not gated;
9c. serve (ROADMAP A15): the port's HTTP server (``ServeState`` behind
   ``make_server`` on 127.0.0.1, real requests through urllib) over
   TorchBackend on the same model at 64 new tokens (SERVE_NEW), in four
   arms, each with every launch counter set to 0 before it: (a) batch
   dispatch, no cache: one POST /v1/generate of the 7 map prompts, whose
   texts must equal a direct TorchBackend.generate of them on a control
   backend byte for byte, K1 = 28 x prefill forwards and K2 = 28 x decode
   steps exactly, K3 = 0; (b) in flight (slots 8, slot_prompt_tokens 4096,
   no cache): the 7 prompts as 7 concurrent requests plus one
   ``"stream": true`` request, all 200, K1 and K3 exactly 28 x the loops'
   join prefill forwards and decode steps, K2 = 0, the stream's deltas
   concatenating to its done text, /debug/trace holding the engine's
   prefill and decode_seg spans (agreement with (a) logged, not gated);
   (c) in flight with a 512-block prefix cache: two waves of the 7
   prompts, every second-wave join resuming at K = 3584 (K1 at that
   q_offset), cache_hit_tokens > 0 on /metrics; (d) one POST /v1/summarize
   of a data/vi_eval document (mapreduce) answering 200 with a summary, K1
   = 28 x prefill forwards and K2 = 28 x decode steps exactly, K3 = 0, and
   /healthz, /readyz and /metrics in their schemas. Each server's close()
   drains within its budget and leaves no scheduler or watchdog thread;
   ``[serve]`` lines give each arm's wall, TTFT and end-to-end p50/p99 from
   the server's own histograms, requests/s, segments and peak memory;
10. long context (path c): PipelineRunner(approach="truncated",
   max_context=32768, max_new_tokens=128, batch_size=2) with a factory
   that builds TorchLongContextBackend (one rank, Llama-3.2-3B at full
   width and depth, random bf16 weights from seed 0, byte tokenizer,
   max_total_tokens = max_context + 1024) over two documents built from
   data/vi_eval (~30,000 and ~20,000 bytes, past the one-card ceiling of
   16,384 tokens), its greedy decode steps captured: 2/2 documents, ROUGE,
   K1 launches = 28 per prefill forward, K2p launches = 28 x decode steps,
   K2 and K3 not launched, steps replayed; then the same with an int8
   prefill cache; then the bf16 run with cuda_graphs=False, whose summaries
   must equal the captured bf16 run's byte for byte; then, not gated, the
   one-card
   engine with max_seq_len 40960 on the same weights and prompts; then,
   gated, the long path's logits (the prefill's last position and the
   first decode steps) against that engine's on the same tokens, at the
   path's shape and a short one, each within its LONG_LOGITS_RTOL, with two
   faults planted in the script's own calls that must exceed it at both;
11. profile: one prefill forward, one decode step (eager and captured) and
   one verify step (Sq=9) at the map batch's shape and one long decode step
   (eager and captured) at path (c)'s, with their wall time, the device's
   busy time (torch.profiler), the card's clock and power draw while they
   run, and the kernels that take most of the time; one replay of each
   captured step must show 28 K2 (K2p) kernels of each pass in the trace;
   [int8] (f): the captured decode step on the same model's int8 copy, its
   113 GEMV kernels and their device time.

Every PipelineRunner and CLI run (pipeline, eager control, weights,
strategies, spec, long context) must report finite sentence cosine (mean,
std, min, max) and BERTScore (P, R, F1), computed by a random-init
minilm_like() encoder on the card; each run's evaluation wall (sentence
embeddings + BERTScore) is logged on an ``[eval]`` line.

Each path phase sets every launch counter to 0 just before it and reads
them just after; a kernel of the path that was not launched fails it. A
replay of a captured step adds the launches its capture counted
(``vnsum_tpu_torch/backend/capture.py``), so the counts are those of the
steps run. The
line before the last is a JSON object with one entry per kernel (K1, K2
and K3 at head_dim 256 and at GQA group 4, K1 at the prefix cache's
resume shape, and the GEMV at Phi-4's widths, entries of their own), whose
``launches`` sums the path phases (the head_dim-256 entries: the Gemma3
phase's; the group-4 and Phi-4 ones: the Phi-4 and Qwen3-8B phases'; the
resume entry: K1's launches in the resumed prefill forwards of phases
9b and 9c); the last line
is the device record. A ``[phase]`` line after each phase gives its
seconds and the run's so far.
Without a card the script exits non-zero and prints neither.
"""
from __future__ import annotations

import contextlib
import ctypes
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor-core rate, HBM rate
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# TOLERANCES: the stated limits on |kernel - plain|, from each kernel's
# sound error.
# decode and verify: the reference is f32 and the kernels differ from it by
#   summation order (~1e-6 relative), by the bf16 hi + lo split of p before
#   PV (at most 2^-18 of p) and then by at most one bf16 ulp in the final
#   cast, where ulp(x) <= 2^-7 |x|: per element, 1e-4 + 2^-7 |plain|.
# prefill: besides, both round p to bf16 before PV, the kernel against its
#   running max and the plain version against the row max: two roundings of
#   up to 2^-9, which move an output by a few 2^-9 of its row's scale, on
#   top of the final cast's 2^-7: per (query, head) row, 2e-2 times the
#   largest |plain| of its hd elements, so a row that sees no key must be 0.
# decode partials (K2p, f32 out, no final cast): the two versions differ by
#   summation order and the 2^-18 of p's hi + lo split. m is a max of
#   128-term f32 dot products, ~1e-6 off: 1e-4 + 1e-5 |m|. l sums up to C
#   exponentials, each off by the score error and the order of the sum,
#   ~1e-6 relative: 1e-4 l. Each element of o sums p v over the same slots,
#   so its error is that of l times max |v|: 1e-5 + 1e-4 l max|v|.
#   o / max(l, 1e-30) is held to K2's output on the same cache at K2's
#   limit. A row that sees no key must be exactly m = -1e30, l = 0, o = 0.
DECODE_ATOL, DECODE_RTOL = 1e-4, 2.0**-7
PREFILL_ROW_RTOL = 2e-2
PARTIALS_M_ATOL, PARTIALS_M_RTOL = 1e-4, 1e-5
PARTIALS_L_RTOL = 1e-4
PARTIALS_O_ATOL, PARTIALS_O_RTOL = 1e-5, 1e-4
# path (c) end to end: the long path's logits against the one-card engine's
# on the same weights and tokens, as max |long - engine| over a forward's
# rows and vocab divided by the largest |engine| logit, per shape. The two
# paths run the same weights through different attention programs (K1 over
# C = S against C = S + steps; K2p, the decode-cache partial and an f32 LSE
# merge against K2). At the path's shape (S = 32768, a multiple of K2's
# 512-slot split) the new tokens sit in a split of their own, so K2 sums the
# same terms in the same order (its merge adds chunks of two splits in
# order, and the prompt's 64 splits are whole chunks) and the logits agree
# exactly (0 on an H100).
# At the short shape (S = 256) they share K2's first split with the prompt:
# another summation order, rounded to bf16 and carried through 28 layers
# (up to 2.7e-2 on an H100). The planted faults read 2.5e-2 to 4.8e-2 at
# the path's shape and 0.08 to 0.61 at the short one (PERF.md).
LONG_LOGITS_RTOL = {"path": 1e-2, "short": 5e-2}
# path (a) end to end: one verify forward of 9 tokens (K3) against 9 decode
# steps (K2) of the same tokens on the same weights, as max |verify -
# decode| over a position's rows and vocab divided by the largest |decode|
# logit. K3 and K2 sum a row's keys in different orders, and the
# projections run as [8 x 9]-row GEMMs against [8 x 1]-row ones, another
# tiling: bf16 roundings carried through 28 layers, 2.8e-2 to 4.1e-2 on an
# H100. The planted fault (a 512-slot split dropped) reads 1.1 to 1.6
# (PERF.md).
SPEC_LOGITS_RTOL = 0.1
# paths (a) and (b) against the one-shot path, the attention kernel alone:
# one greedy decode step's logits through K3 at Sq=1 (every row's fill S,
# as the slot segment runs it) against K2 (a shared fill S), from two
# copies of one prefilled cache with the same [8 x 1]-row GEMMs, as max
# |K3 - K2| over the rows and vocab divided by the largest |K2| logit. The
# two kernels run the same pass 1 on the same tiles and differ in the order
# their second pass sums a row's splits (K2 in chunks of two, K3 one by
# one): ~1e-7 of an f32 output, then a bf16 output near a rounding point
# rounds the other way (2^-8 of it), and such flips carry through the
# layers as the spec gate's do. The limit is the spec gate's; the planted
# fault (a 512-slot split dropped) must exceed it.
STEP_KERNEL_RTOL = 0.1
# phase 6e: the eval encoder's f32 token embeddings on the card against the
# same weights on the CPU, max |card - cpu|. Every matmul is f32 on both
# (TF32 off) and differs only in summation order, ~1e-6 relative per
# product of up to 1536 terms; each layer ends in a LayerNorm, so outputs
# are of unit scale and six layers keep the difference near 1e-5 (2.9e-6
# on an H100). The limit leaves a factor of ~10 for the f32 rsqrt/tanh of
# the two libraries.
ENCODER_ATOL = 1e-4
# [int8] the int8-weight GEMV against its plain version and a float64
#   reckoning of the same formula. All three form every bf16 x int8 product
#   exactly and sum K of them in different orders (the tensor cores', the
#   f32 GEMM's with TF32 off, float64): below 1e-6 of sum_k |x q| s. The
#   projection mode then rounds to bf16 twice (the sum, then the sum times
#   s), and a sum within that error of a half-way point may round to the
#   other neighbour each time: two bf16 ulps, at most 2^-6 of the output.
#   Per element: 2^-6 |ref| + 1e-6 sum_k |x q| s; the head mode (f32 out,
#   no rounding) 1e-6 sum_k |x q| s. The planted faults (a neighbouring
#   channel's scale, the last 16 k dropped, a ring stage read in place of
#   another) move outputs by tens of percent, by ~sqrt(16 / K) of their
#   scale, and by their whole scale.
GEMV_RTOL, GEMV_SUM_RTOL = 2.0**-6, 1e-6
# Llama-3.2-3B's int8 matmuls (weights [N, K]) and the rows the GEMV meets:
# decode at B = 1, 2 and 8, and the spec verify forward's 8 x 9
GEMV_SHAPES = {"wq/wo": (3072, 3072), "wk/wv": (1024, 3072), "w_gate/w_up": (8192, 3072),
               "w_down": (3072, 8192), "head": (128256, 3072)}
GEMV_ROWS = (1, 2, 8, 72)
# the projections that share their input, one grouped launch each:
# (channels of each member, K)
GEMV_GROUPS = {"q/k/v": ((3072, 1024, 1024), 3072), "gate/up": ((8192, 8192), 3072)}
# Phi-4-14B's (phase 6b with --quantize): wo, w_down (K = 17920), the untied
# head (100,352 rows, no power of two) and the grouped q/k/v (40 + 10 + 10
# heads) and gate/up launches, at the same rows
PHI4_GEMV_SHAPES = {"wo": (5120, 5120), "w_down": (5120, 17920), "head": (100352, 5120)}
PHI4_GEMV_GROUPS = {"q/k/v": ((5120, 1280, 1280), 5120), "gate/up": ((17920, 17920), 5120)}

# phase 4's planted faults: (what it does, kernel, source, text, replacement).
# A fault must fail every case of its kernel's family (FAMILY) and no case
# outside it: K2 and K2p share both passes of flash_decode.cu, so each of
# its three faults must fail every K2 and every K2p case; each K1 fault
# must fail every K1 case. Each sits in code that both head_dims run (K2's
# templated passes, K1's shared softmax_tile and stage_addr), so it must
# fail the head_dim-256 cases ("prefill hd=256 ...", "decode hd=256 ...")
# as well.
MUTANTS = (
    ("decode leaves out the last slot of every 512-slot split", "decode", "flash_decode.cu",
     "split * SPLIT + SPLIT - 1", "split * SPLIT + SPLIT - 2"),
    ("the merge of the splits leaves out the l and o of the fill's split", "partials",
     "flash_decode.cu", "s < n_live ? ex2(", "s < n_live - 1 ? ex2("),
    ("decode's in-block merge leaves out the last warp's 128 slots of o", "decode",
     "flash_decode.cu", "w < NWARPS; ++w) acc +=", "w < NWARPS - 1; ++w) acc +="),
    ("prefill leaves out the last slot of every unmasked tile (128 slots; 64 at head_dim 256)",
     "prefill", "flash_prefill.cu",
     "      l_run[i] += p;\n",
     "      if (!MASKED && nt == TN / 8 - 1 && tig == 3 && (e & 1)) p = 0.f;\n"
     "      l_run[i] += p;\n"),
    ("prefill's consumers read K and V from the ring stage TMA did not fill for the tile",
     "prefill", "flash_prefill.cu",
     "return smem_u32(ring + stage * STAGE_BYTES_);",
     "return smem_u32(ring + ((stage + 1) % STAGES) * STAGE_BYTES_);"),
    ("verify leaves out the last slot of every 512-slot split", "verify", "flash_verify.cu",
     "split * SPLIT + SPLIT - 1", "split * SPLIT + SPLIT - 2"),
    ("verify's in-block merge leaves out the last warp's 128 slots of o", "verify",
     "flash_verify.cu", "w < QUARTERS; ++w) acc +=", "w < QUARTERS - 1; ++w) acc +="),
    ("the GEMV scales each output channel with its neighbour's scale", "gemv",
     "int8_gemv.cu", "const float sc = mb.s[n];",
     "const float sc = mb.s[n + 1 < N ? n + 1 : n];"),
    ("the GEMV drops the last 16 bytes of K of every row of q and x", "gemv",
     "int8_gemv.cu", "const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),",
     "const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K - 16),"),
    ("the GEMV's consumers read the ring stage after the one that is full", "gemv",
     "int8_gemv.cu", "const uint8_t *buf = ring + stage * STAGE;",
     "const uint8_t *buf = ring + ((stage + 1) % STAGES) * STAGE;"),
)
FAMILY = {"decode": ("decode", "partials"), "partials": ("decode", "partials")}

KERNELS = {
    "prefill": {
        "name": "flash_prefill_attention",
        "route": "cuda",
        "source": "vnsum_tpu_torch/ops/csrc/flash_prefill.cu",
        "replaces": "vnsum_tpu/ops/flash_attention.py:313",
    },
    "decode": {
        "name": "flash_decode_attention",
        "route": "cuda",
        "source": "vnsum_tpu_torch/ops/csrc/flash_decode.cu",
        "replaces": "vnsum_tpu/ops/decode_attention.py:381",
    },
    "verify": {
        "name": "flash_spec_verify_attention",
        "route": "cuda",
        "source": "vnsum_tpu_torch/ops/csrc/flash_verify.cu",
        "replaces": "vnsum_tpu/ops/decode_attention.py:510",
    },
    # the same pallas_call in its return_partials=True mode
    "partials": {
        "name": "flash_decode_partials",
        "route": "cuda",
        "source": "vnsum_tpu_torch/ops/csrc/flash_decode.cu",
        "replaces": "vnsum_tpu/ops/decode_attention.py:381",
    },
    # K1, K2 and K3 at head_dim 256 (Gemma3), kept apart in the kernels
    # line: a kernel of its own in flash_prefill.cu, an instantiation of its
    # own in flash_decode.cu; times at the map batch on a sliding layer
    # (window 1024, 29 of Gemma3-4B's 34), launches those of the Gemma3
    # phase
    "prefill_hd256": {
        "name": "flash_prefill_attention (head_dim 256)",
        "route": "cuda",
        "source": "vnsum_tpu_torch/ops/csrc/flash_prefill.cu",
        "replaces": "vnsum_tpu/ops/flash_attention.py:313",
    },
    "decode_hd256": {
        "name": "flash_decode_attention (head_dim 256)",
        "route": "cuda",
        "source": "vnsum_tpu_torch/ops/csrc/flash_decode.cu",
        "replaces": "vnsum_tpu/ops/decode_attention.py:381",
    },
    # K3 at head_dim 256: an instantiation of its own in flash_verify.cu
    # (two warps a ring, each accumulating 128 head dims of o); times at
    # the spec step's shape on a sliding layer
    "verify_hd256": {
        "name": "flash_spec_verify_attention (head_dim 256)",
        "route": "cuda",
        "source": "vnsum_tpu_torch/ops/csrc/flash_verify.cu",
        "replaces": "vnsum_tpu/ops/decode_attention.py:510",
    },
    # K1, K2 and K3 at GQA group 4 (Phi-4-14B: 40 query heads on 10 KV
    # heads; Qwen3-8B: 32 on 8), the same kernels at other shapes: times at
    # Phi-4's map batch and spec step (Sq * G = 36 rows), launches those of
    # the Phi-4 and Qwen3-8B phases
    "prefill_g4": {
        "name": "flash_prefill_attention (GQA group 4)",
        "route": "cuda",
        "source": "vnsum_tpu_torch/ops/csrc/flash_prefill.cu",
        "replaces": "vnsum_tpu/ops/flash_attention.py:313",
    },
    "decode_g4": {
        "name": "flash_decode_attention (GQA group 4)",
        "route": "cuda",
        "source": "vnsum_tpu_torch/ops/csrc/flash_decode.cu",
        "replaces": "vnsum_tpu/ops/decode_attention.py:381",
    },
    "verify_g4": {
        "name": "flash_spec_verify_attention (GQA group 4)",
        "route": "cuda",
        "source": "vnsum_tpu_torch/ops/csrc/flash_verify.cu",
        "replaces": "vnsum_tpu/ops/decode_attention.py:510",
    },
    # K1 at the prefix cache's resume shape (B=8, Sq=512 at q_offset 3584,
    # C=4224, int8): the kernel of the "prefill" entry at another shape;
    # launches those of the resumed prefill forwards (phase 9b)
    "prefill_resume": {
        "name": "flash_prefill_attention (prefix-cache resume, q_offset 3584)",
        "route": "cuda",
        "source": "vnsum_tpu_torch/ops/csrc/flash_prefill.cu",
        "replaces": "vnsum_tpu/ops/flash_attention.py:313",
    },
    # a port-only kernel: the JAX package's int8 product is XLA's fusion in
    # _proj (its int8 einsum's line), no pallas_call
    "gemv": {
        "name": "int8_gemv",
        "route": "cuda",
        "source": "vnsum_tpu_torch/ops/csrc/int8_gemv.cu",
        "replaces": "vnsum_tpu/models/llama.py:290",
    },
    # the GEMV at Phi-4-14B's widths (K = 5120 and 17920, a 100,352-row
    # head): a decode step's 161 launches, launches those of its int8 run
    "gemv_phi4": {
        "name": "int8_gemv (Phi-4-14B)",
        "route": "cuda",
        "source": "vnsum_tpu_torch/ops/csrc/int8_gemv.cu",
        "replaces": "vnsum_tpu/models/llama.py:290",
    },
}


def log(msg: str) -> None:
    print(msg, flush=True)


# -- phase 1 ------------------------------------------------------------------


def phase_environment(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(
        f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()} "
        f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}"
    )
    return smi


# -- phase 2 ------------------------------------------------------------------


def phase_build() -> float:
    """Builds every kernel and prints each kernel function's registers and
    spills (ptxas -v), K1's dynamic shared memory, K3's at the main path's
    row counts (Llama-3.2-3B's, Phi-4-14B's and Gemma3-4B's) and K2/K2p's
    pass 1's."""
    from vnsum_tpu_torch.ops import decode_attention as da
    from vnsum_tpu_torch.ops import kernels
    from vnsum_tpu_torch.ops import verify_attention as va

    t0 = time.perf_counter()
    logs = kernels.build_all()
    seconds = time.perf_counter() - t0
    for name, out in logs.items():
        function = "?"
        for line in out.splitlines():
            if "Function properties for" in line:
                function = line.split("Function properties for")[-1].strip()
            elif "registers" in line or "spill" in line:
                log(f"[build] {name} {function}: {line.strip()}")
    log(f"[build] {len(logs)} kernel libraries built in {seconds:.2f}s")
    smem = kernels.load("flash_prefill").vnsum_flash_prefill_smem
    smem.argtypes, smem.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    for hd in (128, 256):
        log(f"[build] flash_prefill dynamic shared memory at head_dim {hd}: "
            f"int8 {smem(1, hd)} B, bf16 {smem(0, hd)} B")
    lib = va._library()
    for hd, rows in ((128, (3, 4, 27, 36)), (256, (2, 18))):
        for R in rows:
            log(f"[build] flash_verify dynamic shared memory at head_dim {hd} Sq*G={R}: "
                f"int8 {lib.vnsum_flash_verify_smem(R, 1, hd)} B, "
                f"bf16 {lib.vnsum_flash_verify_smem(R, 0, hd)} B")
    lib = da._library()
    for hd in (128, 256):
        log(f"[build] flash_decode pass 1 dynamic shared memory at head_dim {hd}: int8 "
            f"{lib.vnsum_flash_decode_smem(1, hd)} B, bf16 {lib.vnsum_flash_decode_smem(0, hd)} B")
    return seconds


# -- inputs -------------------------------------------------------------------


def make_cache(torch, L, B, KV, C, hd, quantized, seed, dev):
    from vnsum_tpu_torch.models.llama import quantize_kv

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    k = torch.randn((L, B, KV, C, hd), generator=g, device=dev, dtype=torch.bfloat16)
    v = torch.randn((L, B, KV, C, hd), generator=g, device=dev, dtype=torch.bfloat16)
    if not quantized:
        return {"k": k, "v": v}
    cache = {
        "k": torch.empty(k.shape, dtype=torch.int8, device=dev),
        "v": torch.empty(k.shape, dtype=torch.int8, device=dev),
        "ks": torch.empty(k.shape[:-1], dtype=torch.float32, device=dev),
        "vs": torch.empty(k.shape[:-1], dtype=torch.float32, device=dev),
    }
    for li in range(L):  # a layer at a time keeps the f32 temporaries small
        cache["k"][li], cache["ks"][li] = quantize_kv(k[li])
        cache["v"][li], cache["vs"][li] = quantize_kv(v[li])
    return cache


def rand_q(torch, shape, seed, dev):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)


FAILED: list[str] = []  # the cases over their limit
CHECKED: list[str] = []  # every case held to its limit


def compare(torch, name, case, got, want, worst) -> None:
    """Holds a kernel's output against its plain version's at the stated
    limit and logs the case: its largest |err| (kept in ``worst[name]``)
    and its largest err/limit. A case over its limit goes into FAILED."""
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    if name.startswith("prefill"):
        limit = PREFILL_ROW_RTOL * want.abs().amax(dim=-1, keepdim=True)
    else:
        limit = DECODE_ATOL + DECODE_RTOL * want.abs()
    err = float(diff.max())
    used = float((diff / limit.clamp_min(1e-30)).max())
    bad = not bool(torch.isfinite(got).all()) or bool((diff > limit).any())
    worst[name] = max(worst[name], err)
    if bad:
        FAILED.append(case)
    CHECKED.append(case)
    log(f"[check] {case}: max|err| {err:.3e}, err/limit {used:.4g}"
        + (" OVER THE LIMIT" if bad else ""))


def compare_partials(torch, case, got, want, k2_out, vmax, worst) -> None:
    """Holds K2p's (o, m, l) against its plain version's, each at its own
    limit, and o / max(l, 1e-30) against K2's output on the same cache at
    K2's limit; logs one line for the case with the largest err/limit of
    the four. ``vmax`` is the largest |v| of the layer."""
    torch.cuda.synchronize()
    (o, m, l), (wo, wm, wl) = got, want
    lw = wl[..., None]
    k2 = k2_out[:, 0].float()
    parts = {
        "o": ((o - wo).abs(), PARTIALS_O_ATOL + PARTIALS_O_RTOL * lw * vmax),
        "m": ((m - wm).abs(), PARTIALS_M_ATOL + PARTIALS_M_RTOL * wm.abs()),
        "l": ((l - wl).abs(), PARTIALS_L_RTOL * wl),
        "o/l vs K2": ((o / l.clamp_min(1e-30)[..., None] - k2).abs(),
                      DECODE_ATOL + DECODE_RTOL * k2.abs()),
    }
    bad = not all(bool(torch.isfinite(t).all()) for t in got)
    used, errs = 0.0, []
    for name, (diff, limit) in parts.items():
        bad = bad or bool((diff > limit).any())
        used = max(used, float((diff / limit.clamp_min(1e-30)).max()))
        errs.append(f"{name} {float(diff.max()):.3e}")
    worst["partials"] = max(worst["partials"], float(parts["o"][0].max()),
                            float(parts["m"][0].max()), float(parts["l"][0].max()))
    if bad:
        FAILED.append(case)
    CHECKED.append(case)
    log(f"[check] {case}: max|err| " + ", ".join(errs) + f"; err/limit {used:.4g}"
        + (" OVER THE LIMIT" if bad else ""))


def raise_if_failed() -> None:
    if FAILED:
        raise AssertionError(
            f"kernels disagree with their plain versions in {len(FAILED)} cases: "
            + "; ".join(FAILED))


# -- phase 3 ------------------------------------------------------------------

# the (B, S) batches at C = S + 128 whose K1 and K2 phase 3 holds to their
# plain versions: the pipeline's map and reduce batches, and STRATEGY_SHAPES
PIPELINE_SHAPES = ((8, 4096), (8, 512))
STRATEGY_SHAPES = tuple((B, S) for B in (1, 2, 4, 8) for S in (512, 1024, 2048, 4096)
                        if (B, S) not in PIPELINE_SHAPES)
# the G-Eval judge's batches (phase 7b). Its prompts are the criteria
# template and one or two summaries: 685-1762 bytes with the pipeline's
# summaries of up to 128 new tokens (up to 384 bytes where the byte
# tokenizer's decode replaces invalid bytes), so S = 1024 or 2048. One file's
# two prompts make B = 2, a call of all 14 two groups at B = 8 (the second
# of 6 prompts and two all-pad filler rows). score_choices prefills at
# C = S (no decode budget), the free-decode judge at C = S + 256: the
# runner builds its engine with max_new_tokens=64, but LLMJudge passes its
# own max_new_tokens (256) to every generate call, which overrides it, in
# the JAX package as here
JUDGE_SHAPES = tuple((B, S) for B in (2, 8) for S in (1024, 2048))
JUDGE_NEW_TOKENS = 256
# the prefix cache's resumed prefill (phase 9b): the query offsets K at
# which a map batch (S = 4096, C = 4224) resumes, on the grid's 512-slot
# steps, the last a warm call's (RESUME_K); S - K queries a row
RESUME_OFFSETS = (512, 2048, 3584)
# the Gemma3 phase's batches: its map and reduce batches (the byte
# tokenizer's, as the pipeline phase's), with their pads: 7 documents and an
# all-pad filler row
GEMMA_SHAPES = {4096: [0, 37, 400, 1000, 2500, 3000, 4095, 4096],
                512: [0, 5, 60, 128, 200, 300, 511, 512]}
GEMMA_KV, GEMMA_G, GEMMA_HD, GEMMA_WINDOW = 4, 2, 256, 1024
# Gemma3's spec path and slot loop (phase 6a): new tokens a request, so the
# spec path's caches are C = S + GEMMA_PATH_NEW + 9 (spec_k 8), its one-shot
# groups' (the oracle's control) C = S + GEMMA_PATH_NEW, and the slot loop's
# C = 4096 + GEMMA_PATH_NEW; its join groups prefill B = 1, 2 or 4 prompts
# at S = 4096. 64, not the CLI's 128: at 128 the whole run came within
# 8 s of the 600 s it must stay under (PERF.md)
GEMMA_PATH_NEW = 64
GEMMA_SPEC_K = 8
GEMMA_JOIN_BATCHES = (1, 2, 4)


# Phi-4-14B's and Qwen3-8B's phases (6b, 6c): GQA group 4 (40 query heads
# on 10 KV heads; 32 on 8) at head_dim 128, the map and reduce batches of
# GEMMA_SHAPES (the byte tokenizer's, as every CLI run's) at FAMILY_NEW new
# tokens, so C = S + FAMILY_NEW; Phi-4's spec path at spec_k 8 (Sq * G = 36
# verify rows: K3's layout of two row halves) and the one-step gate's Sq = 1
# (4 rows) at C = S + 128. 64 new tokens as GEMMA_PATH_NEW, for the time
# budget
PHI4_KV, QWEN3_KV, G4 = 10, 8, 4
FAMILY_NEW = 64
FAMILY_SPEC_K = 8


def phi4_verify_cases() -> list:
    """K3's group-4 cases: (what, S, Sq, C, fills, pads) at every (B, Sq, C)
    Phi-4's spec path and its one-step gate send. The spec step's map batch
    (S = 4096, Sq = 9, C = S + 64 + 9): rows 0-1 put their queries on both
    sides of the 512-slot split boundary at 4096, row 4 is parked at e =
    max_new, row 5's pad hides every key from its queries 0-2, row 7 is the
    all-pad filler row; its reduce batch (S = 512) the same kinds of rows;
    the one-step gate (Sq = 1, C = S + 128, every fill S) with a free row
    (pad = S)."""
    new, k1 = FAMILY_NEW, FAMILY_SPEC_K + 1
    return [
        ("spec S=4096", 4096, k1, 4096 + new + k1,
         [4088, 4095, 4100, 4150, 4096 + new, 4150, 4096, 4111],
         [0, 37, 400, 1000, 2500, 4153, 4095, 4096]),
        ("spec S=512", 512, k1, 512 + new + k1, [505, 511, 512, 560, 512 + new, 530, 512, 520],
         [0, 5, 60, 128, 200, 533, 511, 512]),
        ("step gate", 4096, 1, 4096 + 128, [4096] * 8, [0, 37, 400, 1000, 2500, 3000, 4095, 4096]),
    ]


def gemma_verify_cases() -> list:
    """K3's head_dim-256 cases: (what, S, Sq, C, fills, pads) at every
    (B, Sq, C) Gemma3's spec path and slot loop send. The spec step's map
    batch (S = 4096, Sq = 9): row 0's last query crosses the split boundary
    at 4096 and its window floor (fill - 1023 for query 0) falls inside a
    split, row 1's floor on one (3072), row 4 is parked at e = max_new,
    row 5's pad hides every key from its queries 0-2, row 7 is the all-pad
    filler row (pad = S). Its reduce batch (S = 512): the same kinds of
    rows. The slot segment (Sq = 1, C = 4096 + new): fills 4096 + t_b, row
    6 a free slot (pad = S), row 7 parked at limit C; new = GEMMA_PATH_NEW."""
    new = GEMMA_PATH_NEW
    cases = []
    for S, fills, pads in (
            (4096, [4088, 4095, 4100, 4150, 4096 + new, 4150, 4096, 4111],
             [0, 37, 400, 1000, 2500, 4153, 4095, 4096]),
            (512, [505, 511, 512, 560, 512 + new, 530, 512, 520],
             [0, 5, 60, 128, 200, 533, 511, 512])):
        cases.append((f"spec S={S}", S, GEMMA_SPEC_K + 1, S + new + GEMMA_SPEC_K + 1, fills, pads))
    C = 4096 + new
    cases.append(("slot segment", 4096, 1, C,
                  [4096, 4101, 4113, 4160, 4096 + new - 1, 4096 + new // 2, 4099, C],
                  [0, 37, 400, 1000, 2500, 3000, 4096, 64]))
    return cases


def phase_correctness(torch) -> dict:
    """Every case of phase 3; returns the largest |err| of each kernel and
    raises, after the last case, if any case was over its limit."""
    from vnsum_tpu_torch.models.llama import quantize_kv
    from vnsum_tpu_torch.ops import decode_attention as da
    from vnsum_tpu_torch.ops import flash_attention as fa
    from vnsum_tpu_torch.ops import verify_attention as va

    dev = torch.device("cuda")
    KV, G, hd = 8, 3, 128
    H = KV * G
    worst = {"prefill": 0.0, "decode": 0.0, "verify": 0.0, "partials": 0.0, "gemv": 0.0,
             "prefill_hd256": 0.0, "decode_hd256": 0.0, "verify_hd256": 0.0,
             "prefill_resume": 0.0,
             "prefill_g4": 0.0, "decode_g4": 0.0, "verify_g4": 0.0, "gemv_phi4": 0.0}

    def pads_of(values):
        return torch.tensor(values, dtype=torch.int32, device=dev)

    def verify(case, q, cache, layer, pads_h, fills_h, window=0, blind=(), g=G, key="verify"):
        """K3 against its plain version; ``blind`` lists (row, queries)
        that see no key and must come out 0."""
        pads, fills = pads_of(pads_h), pads_of(fills_h)
        got = va.flash_spec_verify_attention(q, cache, layer, pads, fills, g, window)
        want = va.flash_spec_verify_attention_ref(q, cache, layer, pads, fills, g, window)
        compare(torch, key, f"verify {case}", got, want, worst)
        for row, queries in blind:
            if float(got[row, queries].float().abs().max()) != 0.0:
                FAILED.append(f"verify {case}: row {row} queries {queries} see no key "
                              "and must come out 0")

    def prefill(case, q, cache, layer, pads, window, q_offset, empty_row=None, g=G,
                key="prefill"):
        got = fa.flash_prefill_attention(q, cache, layer, pads, g, window, q_offset)
        want = fa.flash_prefill_attention_ref(q, cache, layer, pads, g, window, q_offset)
        compare(torch, key, f"prefill {case}", got, want, worst)
        if empty_row is not None and float(got[empty_row].float().abs().max()) != 0.0:
            FAILED.append(f"prefill {case}: row {empty_row} sees no key and must come out 0")

    def decode(case, q, cache, layer, pads, fill, window, empty_row=None, g=G, key="decode"):
        got = da.flash_decode_attention(q, cache, layer, pads, fill, g, window)
        want = da.flash_decode_attention_ref(q, cache, layer, pads, fill, g, window)
        compare(torch, key, f"decode {case}", got, want, worst)
        if empty_row is not None and float(got[empty_row].float().abs().max()) != 0.0:
            FAILED.append(f"decode {case}: row {empty_row} sees no key and must come out 0")

    L, B, S, C = 3, 3, 2048, 2176
    for quantized in (False, True):
        cache = make_cache(torch, L, B, KV, C, hd, quantized, 1 + quantized, dev)
        for q_offset, window, layer in ((0, 0, 1), (128, 0, 2), (0, 1024, 1), (128, 1024, 2)):
            q = rand_q(torch, (B, S, H, hd), 7 + q_offset + window, dev)
            # row 2 sees no key: its pad covers every query slot
            prefill(f"int8={quantized} B={B} S={S} C={C} q_offset={q_offset} "
                    f"window={window} layer={layer}", q, cache, layer,
                    pads_of([0, 37, q_offset + S]), window, q_offset, empty_row=2)
        for fill, window, layer in ((2000, 0, 1), (2175, 0, 2), (2000, 1024, 2)):
            q = rand_q(torch, (B, 1, H, hd), 11 + fill + window, dev)
            # row 2 sees no key (pad beyond the fill)
            decode(f"int8={quantized} B={B} C={C} fill={fill} window={window} layer={layer}",
                   q, cache, layer, pads_of([0, 37, C - 1 if fill < C - 1 else 0]), fill,
                   window, empty_row=2 if fill < C - 1 else None)
        del cache

    # the pipeline's own batches (128 new tokens, so C = S + 128): the map
    # batch, 7 documents and an all-pad filler row at bucket 4096, and the
    # reduce batch at bucket 512; decode at the first and the last step
    for S, pads_h in ((4096, [0, 37, 400, 1000, 2500, 3000, 4095, 4096]),
                      (512, [0, 5, 60, 128, 200, 300, 511, 512])):
        B, C, layer = len(pads_h), S + 128, 1
        pads = pads_of(pads_h)
        for quantized in (True, False):
            cache = make_cache(torch, 2, B, KV, C, hd, quantized, 30 + S + quantized, dev)
            q = rand_q(torch, (B, S, H, hd), 31 + S, dev)
            prefill(f"int8={quantized} B={B} S={S} C={C} layer={layer} (pipeline batch)",
                    q, cache, layer, pads, 0, 0, empty_row=B - 1)
            for fill in (S, C - 1):
                qd = rand_q(torch, (B, 1, H, hd), 32 + fill, dev)
                decode(f"int8={quantized} B={B} C={C} fill={fill} layer={layer} "
                       "(pipeline batch)", qd, cache, layer, pads, fill, 0)
            del cache, q, qd
    # the prefix cache's resumed prefill (phase 9b): the map batch's S - K
    # queries at q_offset K over a cache whose slots [0, K) hold seeded
    # values (the gathered blocks), at each of RESUME_OFFSETS, bf16 and
    # int8; rows 0-3 start before K (row 3 one slot before it), rows 4-6
    # after it (no blocks: the whole prompt in [K, S); row 4's first query
    # sees no key), row 7 is the all-pad filler. Then K1 at head_dim 256 at
    # the warm K with Gemma3's window, whose floor (q - 1023) falls inside
    # the gathered span for the first 1023 queries
    S, C = 4096, 4096 + 128
    for K in RESUME_OFFSETS:
        pads_h = [0, 37, K - 300, K - 1, K + 1, K + 200, S - 1, S]
        for quantized in (True, False):
            cache = make_cache(torch, 2, 8, KV, C, hd, quantized, 150 + K + quantized, dev)
            prefill(f"int8={quantized} B=8 S={S} C={C} q_offset={K} layer=1 (prefix-cache "
                    "resume)", rand_q(torch, (8, S - K, H, hd), 151 + K, dev), cache, 1,
                    pads_of(pads_h), 0, K, empty_row=7, key="prefill_resume")
            del cache
    K = RESUME_OFFSETS[-1]
    for quantized in (True, False):
        cache = make_cache(torch, 2, 8, GEMMA_KV, C, GEMMA_HD, quantized, 160 + quantized, dev)
        prefill(f"hd=256 int8={quantized} B=8 S={S} C={C} q_offset={K} window={GEMMA_WINDOW} "
                "layer=1 (gemma3 prefix-cache resume)",
                rand_q(torch, (8, S - K, GEMMA_KV * GEMMA_G, GEMMA_HD), 161, dev), cache, 1,
                pads_of([0, 37, K - 300, K - 1, K + 1, K + 200, S - 1, S]), GEMMA_WINDOW, K,
                empty_row=7, g=GEMMA_G, key="prefill_hd256")
        del cache
    torch.cuda.empty_cache()
    # the strategies' other batches: a round of fewer than 8 prompts
    # buckets B to 1, 2 or 4, and their prompts to S = 512-4096; a partial
    # group packs all-pad filler rows, as the last row here
    for B, S in STRATEGY_SHAPES:
        C, layer = S + 128, 1
        pads_h = [37 * (2 * r + 1) for r in range(B - 1)] + [S if B > 1 else 37]
        pads = pads_of(pads_h)
        for quantized in (True, False):
            cache = make_cache(torch, 2, B, KV, C, hd, quantized, 60 + B + S + quantized, dev)
            prefill(f"int8={quantized} B={B} S={S} C={C} layer={layer} (strategies batch)",
                    rand_q(torch, (B, S, H, hd), 61 + B + S, dev), cache, layer, pads, 0, 0,
                    empty_row=B - 1 if B > 1 else None)
            for fill in (S, C - 1):
                decode(f"int8={quantized} B={B} C={C} fill={fill} layer={layer} "
                       "(strategies batch)", rand_q(torch, (B, 1, H, hd), 62 + B + fill, dev),
                       cache, layer, pads, fill, 0)
            del cache
    # the judge's batches: K1 at C = S (score_choices) and K1 and K2 at
    # C = S + 256 (the free-decode judge); a B = 8 group of 6 prompts packs
    # two all-pad filler rows, as the last two rows here
    for B, S in JUDGE_SHAPES:
        layer = 1
        pads_h = [37, 411] if B == 2 else [37 * (2 * r + 1) for r in range(B - 2)] + [S, S]
        pads = pads_of(pads_h)
        for quantized in (True, False):
            for C in (S, S + JUDGE_NEW_TOKENS):
                cache = make_cache(torch, 2, B, KV, C, hd, quantized, 70 + B + C + quantized, dev)
                prefill(f"int8={quantized} B={B} S={S} C={C} layer={layer} (judge batch)",
                        rand_q(torch, (B, S, H, hd), 71 + B + C, dev), cache, layer, pads, 0, 0,
                        empty_row=B - 1 if B == 8 else None)
                if C > S:
                    for fill in (S, C - 1):
                        decode(f"int8={quantized} B={B} C={C} fill={fill} layer={layer} "
                               "(judge batch)", rand_q(torch, (B, 1, H, hd), 72 + B + fill, dev),
                               cache, layer, pads, fill, 0)
                del cache
    torch.cuda.empty_cache()

    # Gemma3-4B's K1 and K2 at head_dim 256 (KV=4, G=2) at the Gemma3
    # phase's batches (C = S + 128), on a global layer (window 0) and a
    # sliding one (1024), bf16 and int8. K2's fills put the window floor
    # inside a 512-slot split (fill S: floor 3073 or, at S=512, none; C - 1:
    # 3200; 1500: 477, inside K1's 64-slot tile 448-511 too); K1's floor,
    # q - 1023 for a block's first query 32 k, falls inside a tile in every
    # block, and rows whose pad passes the fill see no key
    for S, pads_h in GEMMA_SHAPES.items():
        B, C, layer = len(pads_h), S + 128, 1
        pads = pads_of(pads_h)
        for quantized in (True, False):
            cache = make_cache(torch, 2, B, GEMMA_KV, C, GEMMA_HD, quantized, 80 + S + quantized,
                               dev)
            for window in (0, GEMMA_WINDOW):
                q = rand_q(torch, (B, S, GEMMA_KV * GEMMA_G, GEMMA_HD), 81 + S + window, dev)
                prefill(f"hd=256 int8={quantized} B={B} S={S} C={C} window={window} "
                        f"layer={layer} (gemma3 batch)", q, cache, layer, pads, window, 0,
                        empty_row=B - 1, g=GEMMA_G, key="prefill_hd256")
                for fill in (S, C - 1) + ((1500,) if S == 4096 and window else ()):
                    decode(f"hd=256 int8={quantized} B={B} C={C} fill={fill} window={window} "
                           f"layer={layer} (gemma3 batch)",
                           rand_q(torch, (B, 1, GEMMA_KV * GEMMA_G, GEMMA_HD), 82 + fill, dev),
                           cache, layer, pads, fill, window, g=GEMMA_G, key="decode_hd256")
                del q
            del cache
    torch.cuda.empty_cache()

    # Gemma3's spec path and slot loop at head_dim 256 (gemma_verify_cases):
    # K3 at every shape they send, global and sliding, bf16 and int8 (the
    # reduce batch's int8 only); K1 over the spec path's int8 caches (C =
    # S + GEMMA_PATH_NEW + 9: scale rows no multiple of 16 bytes apart) and
    # the slot loop's join groups (B = 1, 2, 4 at S = 4096); K1 and K2 at
    # the one-shot batches of the spec backend (the oracle's control, and
    # a reduce group whose references are empty), C = S + GEMMA_PATH_NEW
    HG = GEMMA_KV * GEMMA_G
    for what, S, Sq, C, fills_h, pads_h in gemma_verify_cases():
        B = len(fills_h)
        for quantized in (True, False) if S == 4096 else (True,):
            cache = make_cache(torch, 2, B, GEMMA_KV, C, GEMMA_HD, quantized, 100 + C + quantized,
                               dev)
            for window in (0, GEMMA_WINDOW):
                if quantized and Sq > 1:
                    prefill(f"hd=256 int8=True B={B} S={S} C={C} window={window} layer=1 "
                            f"(gemma3 {what})", rand_q(torch, (B, S, HG, GEMMA_HD), 101 + S, dev),
                            cache, 1, pads_of(GEMMA_SHAPES[S]), window, 0, empty_row=B - 1,
                            g=GEMMA_G, key="prefill_hd256")
                q = rand_q(torch, (B, Sq, HG, GEMMA_HD), 102 + C + window, dev)
                verify(f"hd=256 int8={quantized} B={B} Sq={Sq} C={C} window={window} layer=1 "
                       f"(gemma3 {what})", q, cache, 1, pads_h, fills_h, window,
                       blind=((5, slice(0, 3)),) if Sq > 1 else (), g=GEMMA_G,
                       key="verify_hd256")
                del q
            del cache
    for S, pads_h in GEMMA_SHAPES.items():
        B, C = len(pads_h), S + GEMMA_PATH_NEW
        cache = make_cache(torch, 2, B, GEMMA_KV, C, GEMMA_HD, True, 120 + S, dev)
        for window in (0, GEMMA_WINDOW):
            prefill(f"hd=256 int8=True B={B} S={S} C={C} window={window} layer=1 (gemma3 "
                    "spec backend's one-shot)", rand_q(torch, (B, S, HG, GEMMA_HD), 121 + S, dev),
                    cache, 1, pads_of(pads_h), window, 0, empty_row=B - 1, g=GEMMA_G,
                    key="prefill_hd256")
            for fill in (S, C - 1):
                decode(f"hd=256 int8=True B={B} C={C} fill={fill} window={window} layer=1 "
                       "(gemma3 spec backend's one-shot)",
                       rand_q(torch, (B, 1, HG, GEMMA_HD), 122 + fill, dev), cache, 1,
                       pads_of(pads_h), fill, window, g=GEMMA_G, key="decode_hd256")
        del cache
    S, C = 4096, 4096 + GEMMA_PATH_NEW
    for B in GEMMA_JOIN_BATCHES:
        pads_h = [37 * (2 * r + 1) for r in range(B)]
        cache = make_cache(torch, 2, B, GEMMA_KV, C, GEMMA_HD, True, 110 + B, dev)
        for window in (0, GEMMA_WINDOW):
            prefill(f"hd=256 int8=True B={B} S={S} C={C} window={window} layer=1 (gemma3 slot "
                    "join group)", rand_q(torch, (B, S, HG, GEMMA_HD), 111 + B, dev), cache, 1,
                    pads_of(pads_h), window, 0, g=GEMMA_G, key="prefill_hd256")
        del cache
    torch.cuda.empty_cache()

    # K1, K2 and K2p at the other group sizes the kernels take: G=2
    # (Qwen3-0.6B, 16 query heads on 8 KV heads) and G=8, the decode
    # kernels' largest (64 on 8, as Llama-3.1-70B); row 2 sees no key
    C = 2176
    for g in (2, 8):
        for quantized in (False, True):
            cache = make_cache(torch, 2, 3, KV, C, hd, quantized, 90 + g + quantized, dev)
            prefill(f"int8={quantized} G={g} B=3 S=2048 C={C} layer=1", rand_q(
                torch, (3, 2048, KV * g, hd), 92 + g, dev), cache, 1, pads_of([0, 37, 2048]),
                0, 0, empty_row=2, g=g)
            q = rand_q(torch, (3, 1, KV * g, hd), 91 + g, dev)
            decode(f"int8={quantized} G={g} B=3 C={C} fill=2000 layer=1", q, cache, 1,
                   pads_of([0, 37, 2001]), 2000, 0, empty_row=2, g=g)
            check_partials(torch, worst, f"partials int8={quantized} G={g} B=3 C={C} "
                           f"fill={C - 1} pads=[0, 1500, {C}] layer=1", q, cache, 1,
                           pads_of([0, 1500, C]), C - 1, g, inert_rows=(2,))
            del cache, q
    # the fill as an int32 tensor on the device, which the kernel reads there:
    # K2 at the map batch's shape, K2p with a fill past the cache (clamped to
    # C - 1, as the plain version clamps it)
    C = 4096 + 128
    cache = make_cache(torch, 2, 8, KV, C, hd, True, 95, dev)
    q = rand_q(torch, (8, 1, H, hd), 96, dev)
    pads = pads_of([0, 37, 400, 1000, 2500, 3000, 4095, 4096])
    decode(f"int8=True B=8 C={C} fill=4200 on the device layer=1", q, cache, 1, pads,
           pads_of([4200]), 0)
    check_partials(torch, worst, f"partials int8=True B=8 C={C} fill={C + 100} on the device "
                   "(clamped to C - 1) layer=1", q, cache, 1, pads, pads_of([C + 100]), G)
    del cache, q
    torch.cuda.empty_cache()

    # K3 at the spec path's shape: B=8, spec_k 8 (Sq=9), S=4096, 128 new
    # tokens, C = 4096 + 128 + 9. Fills S + e: rows 0-3 put their last query
    # on both sides of the split boundary at 4096 and 4608, row 4 is parked
    # at e = max_new, row 5's pad hides every key from its queries 0-2, row
    # 7 is the all-pad filler row; layer 2 of 3
    S, Sq, C = 4096, 9, 4096 + 128 + 9
    v_fills = [4088, 4090, 4600, 4599, 4096 + 128, 4150, 4096, 4111]
    v_pads = [0, 37, 400, 1000, 2500, 4153, 4095, 4096]
    for quantized in (False, True):
        cache = make_cache(torch, 3, 8, KV, C, hd, quantized, 40 + quantized, dev)
        if quantized:
            # K1 prefills the spec path's cache: its scales' rows, 4 C =
            # 16,932 bytes apart, are no multiple of 16, which TMA refuses
            prefill(f"int8=True B=8 S={S} C={C} layer=2 (spec path)",
                    rand_q(torch, (8, S, H, hd), 42, dev), cache, 2,
                    pads_of([0, 37, 400, 1000, 2500, 3000, 4095, 4096]), 0, 0, empty_row=7)
        for window, layer in ((0, 2), (1024, 1)):
            q = rand_q(torch, (8, Sq, H, hd), 41 + window, dev)
            verify(f"int8={quantized} B=8 Sq={Sq} C={C} window={window} layer={layer} "
                   "(spec path)", q, cache, layer, v_pads, v_fills, window,
                   blind=((5, slice(0, 3)),))
        del cache, q
    # K3 at the slot segment's shape: Sq=1, C = 4096 + 128, fills S + t_b
    # all different, row 6 a free slot (pad = S), row 7 parked at limit C
    C = 4096 + 128
    s_fills = [4096, 4101, 4113, 4160, 4196, 4223, 4096 + 3, 4096 + 128]
    s_pads = [0, 37, 400, 1000, 2500, 3000, 4096, 64]
    for quantized in (False, True):
        cache = make_cache(torch, 2, 8, KV, C, hd, quantized, 50 + quantized, dev)
        verify(f"int8={quantized} B=8 Sq=1 C={C} layer=1 (slot segment)",
               rand_q(torch, (8, 1, H, hd), 51, dev), cache, 1, s_pads, s_fills)
        del cache
    torch.cuda.empty_cache()

    # GQA group 4 (phases 6b and 6c): K1 and K2 at Phi-4-14B's (KV=10) and
    # Qwen3-8B's (KV=8) map and reduce batches at C = S + FAMILY_NEW, the
    # pipeline's pads and an all-pad filler row, int8 (the path's) and, for
    # Phi-4, bf16; decode at the first and the last step
    for family, kv in (("phi4", PHI4_KV), ("qwen3", QWEN3_KV)):
        for S, pads_h in GEMMA_SHAPES.items():
            B, C, layer = len(pads_h), S + FAMILY_NEW, 1
            for quantized in (True, False) if family == "phi4" else (True,):
                cache = make_cache(torch, 2, B, kv, C, hd, quantized, 130 + S + kv + quantized,
                                   dev)
                prefill(f"G=4 KV={kv} int8={quantized} B={B} S={S} C={C} layer={layer} "
                        f"({family} batch)", rand_q(torch, (B, S, kv * G4, hd), 131 + S + kv, dev),
                        cache, layer, pads_of(pads_h), 0, 0, empty_row=B - 1, g=G4,
                        key="prefill_g4")
                for fill in (S, C - 1):
                    decode(f"G=4 KV={kv} int8={quantized} B={B} C={C} fill={fill} layer={layer} "
                           f"({family} batch)", rand_q(torch, (B, 1, kv * G4, hd), 132 + fill, dev),
                           cache, layer, pads_of(pads_h), fill, 0, g=G4, key="decode_g4")
                del cache
    torch.cuda.empty_cache()
    # Phi-4's spec path and one-step gate (phi4_verify_cases): K3 at Sq * G
    # = 36 and 4 rows, int8 and (the map batch's) bf16; K1 over the same
    # int8 caches (C = S + 73 and S + 128: scale rows no multiple of 16
    # bytes apart at 73)
    for what, S, Sq, C, fills_h, pads_h in phi4_verify_cases():
        B = len(fills_h)
        for quantized in (True, False) if S == 4096 else (True,):
            cache = make_cache(torch, 2, B, PHI4_KV, C, hd, quantized, 140 + C + quantized, dev)
            if quantized:
                prefill(f"G=4 KV={PHI4_KV} int8=True B={B} S={S} C={C} layer=1 (phi4 {what})",
                        rand_q(torch, (B, S, PHI4_KV * G4, hd), 141 + S, dev), cache, 1,
                        pads_of(GEMMA_SHAPES[S]), 0, 0, empty_row=B - 1, g=G4, key="prefill_g4")
            verify(f"G=4 KV={PHI4_KV} int8={quantized} B={B} Sq={Sq} C={C} layer=1 "
                   f"(phi4 {what})", rand_q(torch, (B, Sq, PHI4_KV * G4, hd), 142 + C, dev),
                   cache, 1, pads_h, fills_h, blind=((5, slice(0, 3)),) if Sq > 1 else (),
                   g=G4, key="verify_g4")
            del cache
    torch.cuda.empty_cache()

    # the pipeline's default bucket (S=15360, C=16384, B=8, L=28): the last
    # layer of the int8 cache starts past 2^31 elements, so a 32-bit offset
    # anywhere in a kernel reads the wrong layer
    L, B, C, layer = 28, 8, 16384, 27
    shape = (L, B, KV, C, hd)
    cache = {
        "k": torch.zeros(shape, dtype=torch.int8, device=dev),
        "v": torch.zeros(shape, dtype=torch.int8, device=dev),
        "ks": torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
        "vs": torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
    }
    for name in ("k", "v"):
        vals = rand_q(torch, shape[1:], 21 + len(name), dev)
        cache[name][layer], cache[name[0] + "s"][layer] = quantize_kv(vals)
        del vals
    if cache["k"][layer].storage_offset() <= 2**31:
        raise AssertionError("the last layer must start past 2^31 elements")
    pads = pads_of([64 * i for i in range(B)])
    prefill(f"int8=True B={B} S=256 q_offset={C - 256} layer={layer} of a {L}-layer "
            f"C={C} cache (offsets past 2^31)", rand_q(torch, (B, 256, H, hd), 23, dev),
            cache, layer, pads, 0, C - 256)
    decode(f"int8=True B={B} fill={C - 1} layer={layer} of a {L}-layer C={C} cache "
           "(offsets past 2^31)", rand_q(torch, (B, 1, H, hd), 24, dev), cache, layer,
           pads, C - 1, 0)
    verify(f"int8=True B={B} Sq=9 layer={layer} of a {L}-layer C={C} cache "
           "(offsets past 2^31)", rand_q(torch, (B, 9, H, hd), 25, dev), cache, layer,
           [64 * i for i in range(B)], [C - 9 - 100 * i for i in range(B)])
    del cache
    torch.cuda.empty_cache()

    partials_cases(torch, worst)
    gemv_cases(torch, worst)
    gemv_cases(torch, worst, PHI4_GEMV_SHAPES, PHI4_GEMV_GROUPS, "gemv_phi4", seed=500)
    raise_if_failed()
    return worst


def int8_weight(torch, N: int, K: int, seed: int, dev, layers: int = 1):
    """Random int8 weights [layers, N, K] in the stored layout with their
    f32 scales [layers, N], quantized as models/quant.py does from normal
    values whose channels differ in magnitude (0.25-2), so neighbouring
    scales differ; one layer's f32 temporaries at a time."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    q = torch.empty((layers, N, K), dtype=torch.int8, device=dev)
    s = torch.empty((layers, N), dtype=torch.float32, device=dev)
    for li in range(layers):
        w = torch.randn((N, K), generator=g, device=dev)
        w *= 0.25 + 1.75 * torch.rand((N, 1), generator=g, device=dev)
        s[li] = w.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
        q[li] = torch.clamp(torch.round(w / s[li][:, None]), -127, 127).to(torch.int8)
    return q, s


def compare_gemv(torch, case, x, members, head, worst, repeat=False, key="gemv") -> None:
    """Runs the GEMV on x [M, K] and ``members`` [(q [N, K], s [N]), ...]
    (one weight through int8_gemv, more through one int8_gemv_group
    launch) and holds each output against its plain version's and against
    a float64 reckoning of the same formula, bf16(f32(bf16(sum)) * s) or
    sum * s for the head, at the stated limit (GEMV_RTOL, GEMV_SUM_RTOL);
    with ``repeat`` the launch runs again and must give the same bits; logs
    the case as ``compare`` does (its largest |err| in ``worst[key]``)."""
    from vnsum_tpu_torch.ops import int8_matmul as im

    def run():
        if len(members) == 1:
            return [im.int8_gemv(x, *members[0], head)]
        return im.int8_gemv_group(x, members, head)

    outs = run()
    again = run() if repeat else outs
    bad, used, errs = False, 0.0, []
    for got, (q, s) in zip(outs, members):
        want = im.int8_gemv_ref(x, q, s, head)
        q64 = q.double()
        y = (x.double() @ q64.t()).float()
        reckon = y * s if head else (y.to(torch.bfloat16).float() * s).to(torch.bfloat16)
        mag = (x.double().abs() @ q64.abs().t()) * s.double()
        del q64
        torch.cuda.synchronize()
        g = got.double()
        bad = bad or not bool(torch.isfinite(got).all())
        for label, ref in (("plain", want.double()), ("float64", reckon.double())):
            limit = GEMV_SUM_RTOL * mag + (0.0 if head else GEMV_RTOL * ref.abs())
            diff = (g - ref).abs()
            bad = bad or bool((diff > limit).any())
            used = max(used, float((diff / limit.clamp_min(1e-30)).max()))
            errs.append(f"{label} {float(diff.max()):.3e}")
        worst[key] = max(worst[key], float((g - want.double()).abs().max()))
    same = all(torch.equal(a, b) for a, b in zip(outs, again))
    bad = bad or not same
    if bad:
        FAILED.append(case)
    CHECKED.append(case)
    log(f"[check] {case}: max|err| " + ", ".join(errs) + f"; err/limit {used:.4g}"
        + ("; two runs bit-identical" if repeat and same else "")
        + ("; two runs DIFFER" if not same else "")
        + (" OVER THE LIMIT" if bad else ""))


def gemv_cases(torch, worst, shapes=GEMV_SHAPES, groups=GEMV_GROUPS, key="gemv",
               seed=0) -> None:
    """[int8] (a): the GEMV at every int8 matmul shape of a model (``shapes``,
    the head in head mode; Llama-3.2-3B's tied head by default) and at its
    two grouped launches (``groups``), at every row count of GEMV_ROWS,
    against its plain version and a float64 reckoning of the same formula:
    bf16(f32(bf16(sum)) * s), or sum * s for the head; then the grouped
    q/k/v launch at M = 8 twice, which must give the same bits."""
    dev = torch.device("cuda")
    for i, (name, (N, K)) in enumerate(shapes.items()):
        q, s = int8_weight(torch, N, K, seed + 90 + i, dev)
        head = name == "head"
        for M in GEMV_ROWS:
            compare_gemv(torch, f"gemv {name} N={N} K={K} M={M} "
                         f"{'head' if head else 'projection'}",
                         rand_q(torch, (M, K), seed + 100 + 7 * i + M, dev), [(q[0], s[0])],
                         head, worst, key=key)
        del q, s
        torch.cuda.empty_cache()
    for i, (name, (ns, K)) in enumerate(groups.items()):
        members = [tuple(t[0] for t in int8_weight(torch, N, K, seed + 150 + 3 * i + j, dev))
                   for j, N in enumerate(ns)]
        for M in GEMV_ROWS:
            compare_gemv(torch, f"gemv {name} grouped N={'+'.join(map(str, ns))} K={K} M={M} "
                         "projection", rand_q(torch, (M, K), seed + 160 + 7 * i + M, dev),
                         members, False, worst, key=key)
        if name == "q/k/v":
            compare_gemv(torch, f"gemv {name} grouped N={'+'.join(map(str, ns))} K={K} M=8 "
                         "projection, run twice", rand_q(torch, (8, K), seed + 170, dev),
                         members, False, worst, repeat=True, key=key)
        del members
        torch.cuda.empty_cache()


def phase_w8a8(torch) -> None:
    """[int8] (b): W8A8's s8 x s8 -> s32 product (torch._int_mm, what the
    port's prefill runs with quantize_act) on the card at a prefill's shape
    (the reduce batch, 8 x 512 tokens, against wk's 1024 x 3072 int8
    weight) equals the CPU's int32 product bit for bit."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(120)
    qx = torch.randint(-127, 128, (8 * 512, 3072), generator=g, device=dev, dtype=torch.int8)
    q = torch.randint(-127, 128, (1024, 3072), generator=g, device=dev, dtype=torch.int8)
    got = torch._int_mm(qx, q.t()).cpu()
    want = torch._int_mm(qx.cpu(), q.cpu().t())
    if got.dtype != torch.int32 or not torch.equal(got, want):
        raise AssertionError(f"W8A8: torch._int_mm on the card differs from the CPU's int32 "
                             f"product ({int((got != want).sum())} elements)")
    log(f"[int8] W8A8 product [{qx.shape[0]} x {qx.shape[1]}] x [{q.shape[1]} x "
        f"{q.shape[0]}] on the card equals the CPU's int32 product bit for bit")


def partials_cases(torch, worst, dev="cuda") -> None:
    """K2p at the long path's shape: the one-rank prefill cache of two rows
    at S=32768, read whole (fill = C - 1), layers 0 and 27 of 28; pads 0
    and 12000, and a row whose pad is C (it sees no key: exactly inert).
    K1's cases at path (c)'s prefill share the bf16 cache."""
    L, B, KV, G, hd, C = 28, 2, 8, 3, 128, 32768
    H = KV * G
    for quantized in (False, True):
        cache = long_cache(torch, L, B, KV, C, hd, quantized, (0, L - 1), 60 + quantized, dev)
        if not quantized:
            long_prefill_cases(torch, worst, cache, G)
        for layer, pads_h in ((0, [0, 12000]), (L - 1, [12000, C]), (0, [C, 0]),
                              (L - 1, [0, 12000])):
            q = rand_q(torch, (B, 1, H, hd), 61 + layer + pads_h[1], dev)
            pads = torch.tensor(pads_h, dtype=torch.int32, device=dev)
            check_partials(
                torch, worst, f"partials int8={quantized} B={B} C={C} fill={C - 1} "
                f"pads={pads_h} layer={layer}", q, cache, layer, pads, C - 1, G,
                inert_rows=[row for row, pad in enumerate(pads_h) if pad >= C])
        del cache
        torch.cuda.empty_cache()


def check_partials(torch, worst, case, q, cache, layer, pads, fill, G, inert_rows=()) -> None:
    """K2p against its plain version, and o / l against K2, on one input
    (``compare_partials``); each of ``inert_rows`` sees no key and must come
    out exactly m = -1e30, l = 0, o = 0."""
    from vnsum_tpu_torch.ops import decode_attention as da

    got = da.flash_decode_partials(q, cache, layer, pads, fill, G)
    want = da.flash_decode_partials_ref(q, cache, layer, pads, fill, G)
    k2 = da.flash_decode_attention(q, cache, layer, pads, fill, G)
    compare_partials(torch, case, got, want, k2, float(cache_v_amax(cache, layer)), worst)
    for row in inert_rows:
        o, m, l = (t[row] for t in got)
        if not (bool((m == -1e30).all()) and not l.any() and not o.any()):
            FAILED.append(f"{case}: row {row} sees no key and must come out "
                          "exactly m = -1e30, l = 0, o = 0")


def long_prefill_cases(torch, worst, cache, G) -> None:
    """K1 at path (c)'s prefill: the whole causal prefill of B=2 rows at
    S = C = 32768, q_offset 0, over the bf16 stacked cache, with the pads of
    path (c)'s prompts (30,284 and 20,285 tokens), layers 0 and 27 of 28.
    The kernel runs over the whole sequence; four 512-query slices of its
    output (76-588 queries past row 0's pad, across row 1's pad, the
    middle and the last) are held against the plain version on the same
    cache with each slice's q_offset, so the plain version's [512, C]
    scores fit. (Queries right after a pad meet only tiles that the pad or
    the diagonal masks, which the planted fault leaves whole.) Both rows
    see no key in the first 512 queries, which must come out 0."""
    from vnsum_tpu_torch.ops import flash_attention as fa

    L, B, KV, C, hd = cache["k"].shape
    pads_h = [C - 30284, C - 20285]
    pads = torch.tensor(pads_h, dtype=torch.int32, device=cache["k"].device)
    q = rand_q(torch, (B, C, KV * G, hd), 65, cache["k"].device)
    for layer in (0, L - 1):
        got = fa.flash_prefill_attention(q, cache, layer, pads, G, 0, 0)
        case = f"prefill bf16 B={B} S=C={C} pads={pads_h} layer={layer}"
        if float(got[:, :512].float().abs().max()) != 0.0:
            FAILED.append(f"{case}: queries [0, 512) see no key and must come out 0")
        for lo in (pads_h[0] // 512 * 512 + 512, pads_h[1] // 512 * 512, C // 2, C - 512):
            want = fa.flash_prefill_attention_ref(
                q[:, lo : lo + 512].contiguous(), cache, layer, pads, G, 0, lo)
            compare(torch, "prefill", f"{case} queries [{lo}, {lo + 512}) (path (c)'s "
                    "prefill)", got[:, lo : lo + 512], want, worst)
        del got, want
    del q


def long_cache(torch, L, B, KV, C, hd, quantized, layers, seed, dev):
    """A stacked [L, B, KV, C, hd] cache, zero but for random ``layers``
    (bf16, or int8 with f32 scales): the long path's shape without drawing
    every layer."""
    from vnsum_tpu_torch.models.llama import quantize_kv

    shape = (L, B, KV, C, hd)
    dtype = torch.int8 if quantized else torch.bfloat16
    cache = {"k": torch.zeros(shape, dtype=dtype, device=dev),
             "v": torch.zeros(shape, dtype=dtype, device=dev)}
    if quantized:
        cache["ks"] = torch.zeros(shape[:-1], dtype=torch.float32, device=dev)
        cache["vs"] = torch.zeros(shape[:-1], dtype=torch.float32, device=dev)
    for i, li in enumerate(layers):
        for name in ("k", "v"):
            vals = rand_q(torch, shape[1:], seed + 7 * i + len(name), dev)
            if quantized:
                cache[name][li], cache[name + "s"][li] = quantize_kv(vals)
            else:
                cache[name][li] = vals
            del vals
    return cache


def cache_v_amax(cache, layer):
    """The largest |v| of a cache layer, dequantized."""
    v = cache["v"][layer]
    if "vs" not in cache:
        return v.abs().amax().float()
    return (v.abs().amax(dim=-1).float() * cache["vs"][layer]).amax()


# -- phase 4 ------------------------------------------------------------------


def phase_mutants(n_cases: int) -> None:
    """Each planted fault of MUTANTS, built into a temporary copy of the
    package, must run all ``n_cases`` cases of phase 3 there, fail every
    case of its kernel and leave the cases of kernels outside its family
    passing: the limits see a kernel that leaves out one cache slot in 512
    (decode, verify), one in 128 away from the causal diagonal (prefill, up
    to path (c)'s 32768 slots), the 512-slot split that holds the fill
    (decode's merge, down to the fill's one slot where a row sees little
    else), the last warp's 128 slots of a split's o (decode, verify) or a
    tile read from the wrong stage of the ring (prefill). The
    copies build and run four at a time: each holds 10-15 GB of caches at
    its peak, and with five at once one copy stopped short of its last
    cases in one run. Each copy starts from the kernels phase 2 built, so
    it compiles only the source its fault is planted in; all copies compile
    at once (nvcc alone, no card) before the first runs."""
    results = []
    with tempfile.TemporaryDirectory() as root:
        copies = []
        for i, (what, kernel, source, text, replacement) in enumerate(MUTANTS):
            tmp = Path(root) / str(i)
            shutil.copytree(ROOT / "vnsum_tpu_torch", tmp / "vnsum_tpu_torch",
                            ignore=shutil.ignore_patterns("*.tmp", "__pycache__"))
            shutil.copy(ROOT / "chip_smoke.py", tmp)
            cu = tmp / "vnsum_tpu_torch" / "ops" / "csrc" / source
            code = cu.read_text()
            if code.count(text) != 1:
                raise AssertionError(f"planted fault '{what}': its text is not once in {source}")
            cu.write_text(code.replace(text, replacement))
            copies.append(tmp)
        builds = [subprocess.Popen(
            [sys.executable, "-c", "from vnsum_tpu_torch.ops import kernels; kernels.build_all()"],
            cwd=tmp, env={**os.environ, "PYTHONPATH": str(tmp)},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for tmp in copies]
        for (what, *_), p in zip(MUTANTS, builds):
            out = p.communicate(timeout=600)[0]
            if p.returncode != 0:
                raise AssertionError(f"planted fault '{what}' did not build:\n{out[-4000:]}")
        procs = []
        for tmp in copies:
            if len(procs) == 4:
                results += [p.communicate(timeout=600) + (p.returncode,) for p in procs]
                procs = []
            procs.append(subprocess.Popen(
                [sys.executable, "-c", "import torch, chip_smoke as c; "
                 "c.phase_environment(torch); c.phase_build(); c.phase_correctness(torch)"],
                cwd=tmp, env={**os.environ, "PYTHONPATH": str(tmp)},
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            ))
        results += [p.communicate(timeout=600) + (p.returncode,) for p in procs]
    for (what, kernel, *_), (out, err, rc) in zip(MUTANTS, results):
        checks = [ln[len("[check] "):] for ln in out.splitlines() if ln.startswith("[check] ")]
        for line in checks:
            log(f"[mutant] {what}: {line}")
        family = FAMILY.get(kernel, (kernel,))
        mine = [ln for ln in checks if ln.split(" ", 1)[0] in family]
        caught = [ln for ln in mine if ln.endswith("OVER THE LIMIT")]
        others = [ln for ln in checks if ln.split(" ", 1)[0] not in family
                  and ln.endswith("OVER THE LIMIT")]
        if (rc == 0 or len(checks) != n_cases or not mine or len(caught) != len(mine)
                or others):
            raise AssertionError(
                f"planted fault '{what}' was not caught in every {'/'.join(family)} case "
                f"and only there (exit {rc}, {len(checks)} of {n_cases} cases run, "
                f"{len(caught)} of {len(mine)} caught, {len(others)} other cases over):\n"
                + (out + err)[-4000:])
        log(f"[mutant] {what}: over the limit in all {len(mine)} {'/'.join(family)} cases "
            f"and in none of the {len(checks) - len(mine)} outside them, as it must be")


# -- phase 5 ------------------------------------------------------------------


def time_ms(torch, fn, n: int, reps: int = 5) -> float:
    """Median over ``reps`` runs of the mean per-call time of ``n`` calls
    (CUDA events), after one warm-up run."""
    fn(0)
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(n):
            fn(i)
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / n)
    return statistics.median(runs)


def phase_timing(torch, worst) -> dict:
    """Times each kernel, its plain version and the library call at the main
    path's shapes, and holds one output of each kernel against its plain
    version's as phase 3 does (the largest |err| goes into ``worst``)."""
    from vnsum_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    L, B, KV, G, hd = 28, 8, 8, 3, 128
    H = KV * G
    S, C, fill = 4096, 4096 + 128, 4200
    cache = make_cache(torch, L, B, KV, C, hd, True, 3, dev)
    pads_h = [64 * i for i in range(B)]
    lib_layers = 4
    k_lib, v_lib = library_kv(torch, cache, lib_layers, G)
    out = {}
    out["prefill"], out["decode"] = time_prefill_decode(
        torch, worst, "", cache, (k_lib, v_lib), rand_q(torch, (B, S, H, hd), 5, dev),
        rand_q(torch, (B, 1, H, hd), 6, dev), pads_h, fill, G, 0)
    # K1 at the prefix cache's resume shape on the same cache
    out["prefill_resume"] = time_resume_prefill(torch, worst, cache, (k_lib, v_lib), pads_h, G,
                                                RESUME_OFFSETS[-1])

    # verify at the slot segment's shape on the same cache (Sq=1, C=4224,
    # fills S + t_b), then at the spec path's (Sq=9, C=4233, fills S + e_b)
    out["verify_slot"] = time_verify(
        torch, worst, cache, k_lib, v_lib, pads_h, [S + 16 * i for i in range(B)], 1, 31)
    del cache, k_lib, v_lib
    torch.cuda.empty_cache()
    C = S + 128 + 9
    cache = make_cache(torch, L, B, KV, C, hd, True, 4, dev)
    k_lib, v_lib = library_kv(torch, cache, lib_layers, G)
    out["verify"] = time_verify(
        torch, worst, cache, k_lib, v_lib, pads_h, [S + 60 + 3 * i for i in range(B)], 9, 32)
    raise_if_failed()
    for name, rec in out.items():
        log(f"[time] {name}: kernel {rec['ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']}), plain {rec['plain_ms']:.4f} ms, "
            f"library {rec['library_ms']:.4f} ms")
    del cache, k_lib, v_lib
    torch.cuda.empty_cache()

    # K1 alone at the pipeline's default long bucket (chunk_size 12000:
    # S=15360, C=16384), where long documents put their prefill; the plain
    # version and the library call do not fit at this size
    S, C = 15360, 16384
    cache = {
        "k": torch.zeros((L, B, KV, C, hd), dtype=torch.int8, device=dev),
        "v": torch.zeros((L, B, KV, C, hd), dtype=torch.int8, device=dev),
        "ks": torch.ones((L, B, KV, C), dtype=torch.float32, device=dev),
        "vs": torch.ones((L, B, KV, C), dtype=torch.float32, device=dev),
    }
    q = rand_q(torch, (B, S, H, hd), 8, dev)
    pads = torch.zeros(B, dtype=torch.int32, device=dev)
    ms = time_ms(torch, lambda i: fa.flash_prefill_attention(
        q, cache, i % L, pads, G, 0, 0), n=4, reps=3)
    flops = 4 * hd * H * B * S * (S + 1) // 2
    bytes_ = 2 * q.numel() * 2 + 2 * B * S * KV * (hd + 4)
    rec = timing_record(ms, None, None, flops, bytes_, PEAK_BF16_FLOPS)
    log(f"[time] prefill at B={B} S={S} C={C}: kernel {ms:.4f} ms, bound "
        f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), "
        f"{flops / ms / 1e9:.1f} TFLOP/s of causal work")
    del cache, q
    torch.cuda.empty_cache()

    # K2p at the long path's shape, bf16 (the kernels line) and int8
    for quantized in (False, True):
        rec = time_partials(torch, worst, quantized)
        if not quantized:
            out["partials"] = rec
        log(f"[time] partials int8={quantized} B=2 C=32768: kernel {rec['ms']:.4f} ms, bound "
            f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), plain {rec['plain_ms']:.4f} ms, "
            f"library {rec['library_ms']:.4f} ms (normalised output)")
    out["gemv"] = time_gemv(torch, worst)
    out.update(time_gemma_kernels(torch, worst))
    out.update(time_group4_kernels(torch, worst))
    # a Phi-4-14B decode step's launches: 40 x (q/k/v grouped, wo, gate/up
    # grouped, w_down) + the head; 8 layers of weights in turn keep each
    # call cold in L2
    out["gemv_phi4"] = time_gemv(
        torch, worst, PHI4_GEMV_SHAPES, PHI4_GEMV_GROUPS, layers=8, rows=(8,),
        in_step={"q/k/v": 40, "wo": 40, "gate/up": 40, "w_down": 40, "head": 1}, key="gemv_phi4")
    raise_if_failed()
    return out


def time_prefill_decode(torch, worst, tag: str, cache, lib, q, qd, pads_h, fill, G,
                        window) -> tuple[dict, dict]:
    """K1 and K2 on one int8 cache (its layers called in turn) at ``window``:
    the kernel, its plain version and the library call
    (scaled_dot_product_attention with the (windowed) mask on the bf16
    copy ``lib`` of the cache's first layers, K/V expanded to the query
    heads), and the bound of what these inputs need: each visible K/V slot
    and scale read once per KV head (a windowed prefill still reads every
    slot from the pad on, once), q read and the output written once; K1's 4
    hd FLOP per visible (query head, slot) pair, K2's 6 hd (PV run twice, on
    p_hi and p_lo); K2's two passes apart (decode_passes). One output of
    each is held against its plain version as in phase 3 (``worst`` keys
    ``prefill`` and ``decode`` + ``tag``). Returns the two records."""
    from vnsum_tpu_torch.ops import decode_attention as da
    from vnsum_tpu_torch.ops import flash_attention as fa

    F = torch.nn.functional
    L, B, KV, C, hd = cache["k"].shape
    S, H = q.shape[1], q.shape[2]
    dev = q.device
    k_lib, v_lib = lib
    pads = torch.tensor(pads_h, dtype=torch.int32, device=dev)
    kpos, qpos = torch.arange(C, device=dev), torch.arange(S, device=dev)
    pre_mask = ((kpos[None, None, :] >= pads.long()[:, None, None])
                & (kpos[None, None, :] <= qpos[None, :, None]))
    dec_mask = (kpos >= pads.long()[:, None]) & (kpos <= fill)
    if window:
        pre_mask = pre_mask & (kpos[None, None, :] > qpos[None, :, None] - window)
        dec_mask = dec_mask & (kpos > fill - window)
    pre_mask, dec_mask = pre_mask[:, None], dec_mask[:, None, None, :]
    qt, qdt = q.transpose(1, 2), qd.transpose(1, 2)
    case = (f"{tag.replace('_hd', 'hd=').replace('_g', 'G=') + ' ' if tag else ''}int8=True B={B}"
            + (f" window={window}" if window else ""))
    # prefill: query q of row b sees min(q - pad_b + 1, window) slots
    pairs = sum(min(qq - p + 1, window or S) for p in pads_h for qq in range(p, S))
    flops = 4 * hd * H * pairs
    bytes_ = 2 * q.numel() * 2 + 2 * sum(S - p for p in pads_h) * KV * (hd + 4)
    ms = time_ms(torch, lambda i: fa.flash_prefill_attention(
        q, cache, i % L, pads, G, window, 0), n=2 * L)
    plain = time_ms(torch, lambda i: fa.flash_prefill_attention_ref(
        q, cache, i % L, pads, G, window, 0), n=1, reps=3)
    library = time_ms(torch, lambda i: F.scaled_dot_product_attention(
        qt, k_lib[i % len(k_lib)], v_lib[i % len(k_lib)], attn_mask=pre_mask),
        n=2 * len(k_lib))
    pre = timing_record(ms, plain, library, flops, bytes_, PEAK_BF16_FLOPS)
    compare(torch, "prefill" + tag, f"prefill {case} S={S} C={C} layer={L - 1} (timing inputs)",
            fa.flash_prefill_attention(q, cache, L - 1, pads, G, window, 0),
            fa.flash_prefill_attention_ref(q, cache, L - 1, pads, G, window, 0), worst)
    # decode: one query per row over slots max(pad_b, fill - window + 1)..fill
    visible = sum(fill + 1 - max(p, fill - window + 1 if window else 0) for p in pads_h)
    flops = 6 * hd * H * visible
    bytes_ = 2 * qd.numel() * 2 + 2 * visible * KV * (hd + 4)
    ms = time_ms(torch, lambda i: da.flash_decode_attention(
        qd, cache, i % L, pads, fill, G, window), n=4 * L)
    decode_passes(torch, f"decode {case} C={C} fill={fill}", ms,
                  lambda i: da.flash_decode_attention(qd, cache, i % L, pads, fill, G, window),
                  4 * L)
    plain = time_ms(torch, lambda i: da.flash_decode_attention_ref(
        qd, cache, i % L, pads, fill, G, window), n=L)
    library = time_ms(torch, lambda i: F.scaled_dot_product_attention(
        qdt, k_lib[i % len(k_lib)], v_lib[i % len(k_lib)], attn_mask=dec_mask),
        n=4 * len(k_lib))
    dec = timing_record(ms, plain, library, flops, bytes_, PEAK_BF16_FLOPS)
    compare(torch, "decode" + tag, f"decode {case} C={C} fill={fill} layer={L - 1} "
            "(timing inputs)", da.flash_decode_attention(qd, cache, L - 1, pads, fill, G, window),
            da.flash_decode_attention_ref(qd, cache, L - 1, pads, fill, G, window), worst)
    return pre, dec


def time_resume_prefill(torch, worst, cache, lib, pads_h, G, K: int) -> dict:
    """K1 at the prefix cache's resume shape: the map batch's last S - K
    queries a row at q_offset K (B=8, S=4096, Sq=512 at K=3584, C=4224, the
    int8 cache's layers in turn): the kernel, its plain version, the
    library call (scaled_dot_product_attention with the explicit mask on
    the bf16 copy ``lib``, K/V expanded to the query heads) and the bound
    of what these inputs need (each visible K/V slot and scale read once per
    KV head, from the pad on; q read and the output written once; K1's 4 hd
    FLOP per visible (query head, slot) pair). One output is held against
    the plain version as in phase 3 (``worst["prefill_resume"]``)."""
    from vnsum_tpu_torch.ops import flash_attention as fa

    L, B, KV, C, hd = cache["k"].shape
    S, H, dev = 4096, KV * G, cache["k"].device
    q = rand_q(torch, (B, S - K, H, hd), 12, dev)
    pads = torch.tensor(pads_h, dtype=torch.int32, device=dev)
    kpos, qpos = torch.arange(C, device=dev), K + torch.arange(S - K, device=dev)
    mask = ((kpos[None, None, :] >= pads.long()[:, None, None])
            & (kpos[None, None, :] <= qpos[None, :, None]))[:, None]
    pairs = sum(qq - p + 1 for p in pads_h for qq in range(max(p, K), S))
    flops = 4 * hd * H * pairs
    bytes_ = 2 * q.numel() * 2 + 2 * sum(S - p for p in pads_h) * KV * (hd + 4)
    k_lib, v_lib = lib
    qt = q.transpose(1, 2)
    ms = time_ms(torch, lambda i: fa.flash_prefill_attention(q, cache, i % L, pads, G, 0, K),
                 n=2 * L)
    plain = time_ms(torch, lambda i: fa.flash_prefill_attention_ref(
        q, cache, i % L, pads, G, 0, K), n=1, reps=3)
    library = time_ms(torch, lambda i: torch.nn.functional.scaled_dot_product_attention(
        qt, k_lib[i % len(k_lib)], v_lib[i % len(k_lib)], attn_mask=mask), n=2 * len(k_lib))
    compare(torch, "prefill_resume", f"prefill int8=True B={B} S={S} C={C} q_offset={K} "
            f"layer={L - 1} (prefix-cache resume, timing inputs)",
            fa.flash_prefill_attention(q, cache, L - 1, pads, G, 0, K),
            fa.flash_prefill_attention_ref(q, cache, L - 1, pads, G, 0, K), worst)
    return timing_record(ms, plain, library, flops, bytes_, PEAK_BF16_FLOPS)


def time_gemma_kernels(torch, worst) -> dict:
    """K1 and K2 at head_dim 256 at Gemma3-4B's map batch (B=8, S=4096,
    C=4224, KV=4, G=2, an int8 cache of 8 layers, 69 MB of K/V a layer, so
    each call finds its layer cold in L2; pads 64 b, K2 at fill 4200) on a
    global layer (window 0) and a sliding one (1024), through
    time_prefill_decode; then K3 at head_dim 256 through time_verify at the
    Gemma3 slot loop's shape (Sq=1, C = S + GEMMA_PATH_NEW, fills S + 3 b)
    and its spec step's (Sq=9, C = S + GEMMA_PATH_NEW + 9, fills S + 30 +
    3 b), each on a global and a sliding layer. Returns the sliding layer's
    records (K3's at the spec step's shape)."""
    dev = torch.device("cuda")
    L, B, KV, G, hd = 8, 8, GEMMA_KV, GEMMA_G, GEMMA_HD
    S, C, fill = 4096, 4096 + 128, 4200
    cache = make_cache(torch, L, B, KV, C, hd, True, 13, dev)
    lib = library_kv(torch, cache, 4, G)
    q = rand_q(torch, (B, S, KV * G, hd), 14, dev)
    qd = rand_q(torch, (B, 1, KV * G, hd), 15, dev)
    out = {}
    for window in (0, GEMMA_WINDOW):
        kind = "sliding" if window else "global"
        pre, dec = time_prefill_decode(torch, worst, "_hd256", cache, lib, q, qd,
                                       [64 * i for i in range(B)], fill, G, window)
        for name, rec in (("prefill", pre), ("decode", dec)):
            log(f"[time] {name} hd=256 {kind} (window {window}): kernel {rec['ms']:.4f} ms, "
                f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}), plain "
                f"{rec['plain_ms']:.4f} ms, library {rec['library_ms']:.4f} ms")
        out["prefill_hd256"], out["decode_hd256"] = pre, dec  # the sliding layer's last
    del cache, lib, q, qd
    torch.cuda.empty_cache()
    pads_h = [64 * i for i in range(B)]
    for what, Sq, fills_h in (("slot", 1, [S + 3 * i for i in range(B)]),
                              ("spec", GEMMA_SPEC_K + 1, [S + 30 + 3 * i for i in range(B)])):
        C = S + GEMMA_PATH_NEW + (Sq if Sq > 1 else 0)
        cache = make_cache(torch, L, B, KV, C, hd, True, 16 + Sq, dev)
        lib = library_kv(torch, cache, 4, G)
        for window in (0, GEMMA_WINDOW):
            rec = time_verify(torch, worst, cache, *lib, pads_h, fills_h, Sq, 17 + Sq + window,
                              window, "verify_hd256")
            log(f"[time] verify hd=256 {what} B={B} Sq={Sq} C={C} "
                f"{'sliding' if window else 'global'} (window {window}): kernel "
                f"{rec['ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}), plain "
                f"{rec['plain_ms']:.4f} ms, library {rec['library_ms']:.4f} ms")
        out["verify_hd256"] = rec  # the spec step's, sliding
        del cache, lib
        torch.cuda.empty_cache()
    return out


def time_group4_kernels(torch, worst) -> dict:
    """GQA group 4 at Phi-4-14B's shapes (KV=10, G=4, head_dim 128): K1 and
    K2 at its map batch (B=8, S=4096, C = S + FAMILY_NEW = 4160, an int8
    cache of 8 layers, 85 MB of K/V a layer, so each call finds its layer
    cold in L2; pads 64 b, K2 at fill S + 32) through time_prefill_decode;
    K3 through time_verify at its spec step (Sq=9: 36 rows, C = S + 64 + 9,
    fills S + 30 + 3 b) and at the one-step gate's shape (Sq=1: 4 rows, C =
    S + 128, fills S + 16 b). Returns the records of K1, K2 and K3 at the
    spec step."""
    dev = torch.device("cuda")
    L, B, KV, G, hd, S = 8, 8, PHI4_KV, G4, 128, 4096
    pads_h = [64 * i for i in range(B)]
    cache = make_cache(torch, L, B, KV, S + FAMILY_NEW, hd, True, 19, dev)
    lib = library_kv(torch, cache, 4, G)
    pre, dec = time_prefill_decode(
        torch, worst, "_g4", cache, lib, rand_q(torch, (B, S, KV * G, hd), 20, dev),
        rand_q(torch, (B, 1, KV * G, hd), 21, dev), pads_h, S + 32, G, 0)
    for name, rec in (("prefill", pre), ("decode", dec)):
        log(f"[time] {name} G=4 (Phi-4 map batch, C={S + FAMILY_NEW}): kernel "
            f"{rec['ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}), plain "
            f"{rec['plain_ms']:.4f} ms, library {rec['library_ms']:.4f} ms")
    del cache, lib
    torch.cuda.empty_cache()
    out = {"prefill_g4": pre, "decode_g4": dec}
    for what, Sq, C, fills_h in (
            ("spec", FAMILY_SPEC_K + 1, S + FAMILY_NEW + FAMILY_SPEC_K + 1,
             [S + 30 + 3 * i for i in range(B)]),
            ("slot", 1, S + 128, [S + 16 * i for i in range(B)])):
        cache = make_cache(torch, L, B, KV, C, hd, True, 22 + Sq, dev)
        lib = library_kv(torch, cache, 4, G)
        rec = time_verify(torch, worst, cache, *lib, pads_h, fills_h, Sq, 23 + Sq, 0, "verify_g4")
        log(f"[time] verify G=4 {what} B={B} Sq={Sq} (Sq*G={Sq * G}) C={C}: kernel "
            f"{rec['ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}), plain "
            f"{rec['plain_ms']:.4f} ms, library {rec['library_ms']:.4f} ms")
        if what == "spec":
            out["verify_g4"] = rec
        del cache, lib
        torch.cuda.empty_cache()
    return out


def graph_ms(torch, fn, n: int, reps: int = 5) -> float:
    """Per-call device time of ``fn(i)`` for i < n, recorded once into a
    CUDA graph and replayed (median over ``reps`` replays, CUDA events), so
    the host's launch time stays out, as in a captured decode step."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up, as PyTorch's graph notes ask
        for i in range(n):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            fn(i)
    ms = time_ms(torch, lambda _: graph.replay(), n=1, reps=reps) / n
    del graph
    return ms


def int8pack_call(torch):
    """torch._weight_int8pack_mm(x, q, s) (bf16 x [M, K], int8 q [N, K],
    per-channel scales in x's dtype: (x q^T) s rounded once), the one public
    PyTorch call near the GEMV's function, where the installed torch runs it
    on the card; else None, with the reason logged. Timed only, never used
    by the port."""
    dev = torch.device("cuda")
    x = rand_q(torch, (8, 256), 180, dev)
    q, s = int8_weight(torch, 64, 256, 181, dev)
    try:
        got = torch._weight_int8pack_mm(x, q[0], s[0].to(torch.bfloat16))
        torch.cuda.synchronize()
    except (AttributeError, NotImplementedError, RuntimeError) as err:
        log(f"[int8] torch._weight_int8pack_mm does not run on the card: "
            f"{type(err).__name__}: {str(err).splitlines()[0][:200]}")
        return None
    want = (x.float() @ q[0].float().t()) * s[0]
    err = float((got.float() - want).abs().max() / want.abs().max())
    log(f"[int8] torch._weight_int8pack_mm runs on the card: {tuple(got.shape)} "
        f"{got.dtype}, max|err| {err:.3e} of the largest output against the f32 product")
    return torch._weight_int8pack_mm


def time_gemv(torch, worst, shapes=GEMV_SHAPES, groups=GEMV_GROUPS, layers=28,
              rows=GEMV_ROWS, in_step=None, key="gemv") -> dict:
    """[int8] (e): the GEMV at each shape of phase 3, the single weights
    (``shapes``, Llama-3.2-3B's GEMV_SHAPES by default) and the grouped
    launches (``groups``), at each row count of ``rows``, ``layers`` layers
    of weights called in turn so that each call finds its weights cold in
    L2 as a decode step does (the head, 394 MB at Llama's widths, is past
    L2 alone), each time from one replayed CUDA graph: the kernel,
    the library calls, ``torch.matmul`` of x against the same weights in
    bf16 (what the bf16 model pays) and torch._weight_int8pack_mm where it
    runs (int8pack_call), one call over the members' weights side by side,
    and at M = 8 the plain version. The bound of a call: its int8 weights
    and scales read once (and x, and the outputs written) at 3.35 TB/s; its
    bf16 tensor-core work is a few percent of that. The returned record is
    one decode step's sum at M = 8 over ``in_step`` (launches a step by
    shape; by default Llama-3.2-3B's 28 x (q/k/v grouped, wo, gate/up
    grouped, w_down) + the head, 113 calls); its library time is
    _weight_int8pack_mm's where it runs, else bf16 torch.matmul's. One
    output at each shape is held to the plain version as in phase 3
    (``worst[key]``)."""
    from vnsum_tpu_torch.ops import int8_matmul as im

    dev = torch.device("cuda")
    L, step_m = layers, 8
    int8pack = int8pack_call(torch)
    in_step = in_step or {"q/k/v": 28, "wq/wo": 28, "gate/up": 28, "w_down": 28, "head": 1}
    shapes = {name: ((N,), K) for name, (N, K) in shapes.items()}
    shapes.update(groups)
    step = {"ms": 0.0, "plain": 0.0, "library": 0.0, "bf16": 0.0, "flops": 0, "bytes": 0}
    for i, (name, (ns, K)) in enumerate(shapes.items()):
        head = name == "head"
        layers = 1 if head else L
        offs = [sum(ns[:j]) for j in range(len(ns))]
        qcat, scat = int8_weight(torch, sum(ns), K, 130 + i, dev, layers)
        wb = torch.empty(qcat.shape, dtype=torch.bfloat16, device=dev)
        for li in range(layers):
            wb[li] = (qcat[li].float() * scat[li][:, None]).to(torch.bfloat16)
        s16 = scat.to(torch.bfloat16)

        def members(li):
            return [(qcat[li, o:o + N], scat[li, o:o + N]) for o, N in zip(offs, ns)]

        def kernel(x, li):
            if len(ns) == 1:
                return im.int8_gemv(x, *members(li)[0], head)
            return im.int8_gemv_group(x, members(li), head)

        for M in rows:
            x = rand_q(torch, (M, K), 140 + 7 * i + M, dev)
            n = 2 * layers
            ms = graph_ms(torch, lambda j: kernel(x, j % layers), n)
            bf16 = graph_ms(torch, lambda j: torch.matmul(x, wb[j % layers].t()), n)
            pack = (graph_ms(torch, lambda j: int8pack(x, qcat[j % layers], s16[j % layers]), n)
                    if int8pack else None)
            plain = (graph_ms(torch, lambda j: [im.int8_gemv_ref(x, q, s, head)
                                                for q, s in members(j % layers)], layers)
                     if M == step_m else None)
            N = sum(ns)
            bytes_ = N * K + 4 * N + 2 * M * K + (4 if head else 2) * M * N
            flops = 2 * M * N * K
            rec = timing_record(ms, plain, pack if pack else bf16, flops, bytes_,
                                PEAK_BF16_FLOPS)
            calls = in_step.get(name, 0) if M == step_m else 0
            if M == step_m:
                compare_gemv(torch, f"gemv {name} N={'+'.join(map(str, ns))} K={K} M={M} "
                             "(timing inputs)", x, members(layers - 1), head, worst, key=key)
                for part, val in (("ms", ms), ("plain", plain), ("library", rec["library_ms"]),
                                  ("bf16", bf16), ("flops", flops), ("bytes", bytes_)):
                    step[part] += calls * val
            log(f"[time] gemv {name} N={'+'.join(map(str, ns))} K={K} M={M}"
                + (f" ({calls} a decode step)" if M == step_m else "")
                + f": kernel {ms:.4f} ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}, "
                f"{rec['bound_ms'] / ms:.1%} of it), library bf16 torch.matmul {bf16:.4f} ms, "
                + (f"_weight_int8pack_mm {pack:.4f} ms" if pack else "_weight_int8pack_mm "
                   "not run")
                + (f", plain {plain:.4f} ms" if plain is not None else ""))
        del qcat, scat, wb, s16
        torch.cuda.empty_cache()
    rec = timing_record(step["ms"], step["plain"], step["library"], step["flops"],
                        step["bytes"], PEAK_BF16_FLOPS)
    log(f"[time] gemv, one decode step's {sum(in_step.values())} calls at M={step_m}: kernel "
        f"{rec['ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}, "
        f"{step['bytes'] / 1e9:.3f} GB, {rec['bound_ms'] / rec['ms']:.1%} of it), plain "
        f"{rec['plain_ms']:.4f} ms, library "
        + (f"_weight_int8pack_mm {rec['library_ms']:.4f} ms, " if int8pack else "")
        + f"bf16 torch.matmul {step['bf16']:.4f} ms")
    return rec


def time_partials(torch, worst, quantized: bool) -> dict:
    """K2p, its plain version and the library call at the long path's
    decode: B=2, the whole one-rank prefill cache of C=32768 slots read
    (fill = C - 1), pads 0 and 12000. The library call computes the
    normalised output from a bf16 copy of the cache expanded to 24 heads.
    The bound counts each row's visible K/V slots (and int8 scales) read
    once, q read and (o, m, l) written once, and, on bf16 tensor cores, 2
    hd FLOP of QK and 2 x 2 hd of PV (p_hi and p_lo) per visible (query
    head, slot) pair. Pass 1 and the merge are timed apart (torch.profiler).
    One output is held against the plain version's as in phase 3."""
    from vnsum_tpu_torch.ops import decode_attention as da

    dev = torch.device("cuda")
    L, B, KV, G, hd, C = 4, 2, 8, 3, 128, 32768
    H = KV * G
    cache = long_cache(torch, L, B, KV, C, hd, quantized, range(L), 70 + quantized, dev)
    pads_h = [0, 12000]
    pads = torch.tensor(pads_h, dtype=torch.int32, device=dev)
    q = rand_q(torch, (B, 1, H, hd), 71, dev)
    visible = sum(C - p for p in pads_h)
    elem = 1 if quantized else 2
    flops = 6 * hd * H * visible
    bytes_ = (q.numel() * 2 + 2 * visible * KV * (hd * elem + (4 if quantized else 0))
              + B * H * (hd + 2) * 4)
    ms = time_ms(torch, lambda i: da.flash_decode_partials(q, cache, i % L, pads, C - 1, G),
                 n=4 * L)
    decode_passes(torch, f"partials int8={quantized} B={B} C={C}", ms,
                  lambda i: da.flash_decode_partials(q, cache, i % L, pads, C - 1, G), 4 * L)
    plain = time_ms(torch, lambda i: da.flash_decode_partials_ref(
        q, cache, i % L, pads, C - 1, G), n=L)
    k_lib, v_lib = library_kv(torch, cache, L, G)
    kpos = torch.arange(C, device=dev)
    mask = (kpos >= pads.long()[:, None])[:, None, None, :]
    qt = q.transpose(1, 2)
    library = time_ms(torch, lambda i: torch.nn.functional.scaled_dot_product_attention(
        qt, k_lib[i % L], v_lib[i % L], attn_mask=mask), n=4 * L)
    layer = L - 1
    compare_partials(
        torch, f"partials int8={quantized} B={B} C={C} pads={pads_h} layer={layer} "
        "(timing inputs)", da.flash_decode_partials(q, cache, layer, pads, C - 1, G),
        da.flash_decode_partials_ref(q, cache, layer, pads, C - 1, G),
        da.flash_decode_attention(q, cache, layer, pads, C - 1, G),
        float(cache_v_amax(cache, layer)), worst)
    del cache, k_lib, v_lib
    torch.cuda.empty_cache()
    return timing_record(ms, plain, library, flops, bytes_, PEAK_BF16_FLOPS)


def decode_passes(torch, label: str, ms: float, fn, n: int) -> None:
    """Logs K2's or K2p's two passes apart, device time a call
    (torch.profiler), beside the CUDA-event time of both."""
    passes = kernel_ms(torch, fn, n=n)
    split_ms = sum(v for k, v in passes.items() if "flash_decode_split_kernel" in k)
    merge_ms = sum(v for k, v in passes.items() if "flash_decode_merge_kernel" in k)
    log(f"[time] {label} passes: pass 1 {split_ms:.4f} ms, merge {merge_ms:.4f} ms a call "
        f"(torch.profiler; CUDA events around both: {ms:.4f} ms)")


def library_kv(torch, cache, layers: int, G: int):
    """bf16 K/V of the first ``layers`` layers of a cache (an int8 one
    dequantized), expanded to the query heads, for the library call."""
    def layer(name, li):
        x = cache[name][li]
        if name + "s" in cache:
            x = (x.float() * cache[name + "s"][li][..., None]).to(torch.bfloat16)
        return x.repeat_interleave(G, dim=1)

    return ([layer("k", li) for li in range(layers)],
            [layer("v", li) for li in range(layers)])


def time_verify(torch, worst, cache, k_lib, v_lib, pads_h, fills_h, Sq, seed, window=0,
                key="verify") -> dict:
    """K3, its plain version and the library call on one int8 cache at Sq
    queries per row, per-row fills and ``window``, and K3's two passes apart
    (torch.profiler); one output of the kernel is held against the plain
    version's as in phase 3 (``worst[key]``). The bound counts what these
    inputs need: each row's visible K/V slots and scales read once (from
    its first query's window floor), q read and the output written once,
    and, on bf16 tensor cores, 2 hd FLOP of QK and 2 x 2 hd of PV (run once
    with p_hi and once with p_lo) per visible (query head, slot) pair."""
    from vnsum_tpu_torch.ops import verify_attention as va

    dev = cache["k"].device
    L, B, KV, C, hd = cache["k"].shape
    G = k_lib[0].shape[1] // KV
    H = KV * G
    pads = torch.tensor(pads_h, dtype=torch.int32, device=dev)
    fills = torch.tensor(fills_h, dtype=torch.int32, device=dev)
    q = rand_q(torch, (B, Sq, H, hd), seed, dev)
    limit = fills.long()[:, None] + torch.arange(Sq, device=dev)[None, :]
    kpos = torch.arange(C, device=dev)
    mask = ((kpos[None, None, :] >= pads.long()[:, None, None])
            & (kpos[None, None, :] <= limit[:, :, None]))
    if window:
        mask = mask & (kpos[None, None, :] > limit[:, :, None] - window)
    mask = mask[:, None]
    qt = q.transpose(1, 2)

    def first(p, f, s):  # the first slot query s of a row sees
        return max(p, f + s - window + 1) if window else p

    pairs = sum(max(min(f + s, C - 1) - first(p, f, s) + 1, 0)
                for p, f in zip(pads_h, fills_h) for s in range(Sq))
    rows = sum(max(min(f + Sq - 1, C - 1) - first(p, f, 0) + 1, 0)
               for p, f in zip(pads_h, fills_h))
    flops = 6 * hd * H * pairs
    bytes_ = 2 * q.numel() * 2 + 2 * rows * KV * (hd + 4)
    ms = time_ms(torch, lambda i: va.flash_spec_verify_attention(
        q, cache, i % L, pads, fills, G, window), n=4 * L)
    passes = kernel_ms(torch, lambda i: va.flash_spec_verify_attention(
        q, cache, i % L, pads, fills, G, window), n=4 * L)
    split_ms = sum(v for k, v in passes.items() if "flash_verify_split_kernel" in k)
    merge_ms = sum(v for k, v in passes.items() if "flash_verify_merge_kernel" in k)
    tag = f"hd={hd} " if hd != 128 else ""
    tag += f"G={G} " if G == G4 else ""
    tag += f"window={window} " if window else ""
    log(f"[time] verify passes {tag}B={B} Sq={Sq} C={C}: pass 1 {split_ms:.4f} ms, merge "
        f"{merge_ms:.4f} ms a call (torch.profiler; CUDA events around both: {ms:.4f} ms)")
    plain = time_ms(torch, lambda i: va.flash_spec_verify_attention_ref(
        q, cache, i % L, pads, fills, G, window), n=4)
    library = time_ms(torch, lambda i: torch.nn.functional.scaled_dot_product_attention(
        qt, k_lib[i % len(k_lib)], v_lib[i % len(k_lib)], attn_mask=mask), n=4 * len(k_lib))
    compare(torch, key, f"verify {tag}int8=True B={B} Sq={Sq} C={C} layer={L - 1} "
            "(timing inputs)",
            va.flash_spec_verify_attention(q, cache, L - 1, pads, fills, G, window),
            va.flash_spec_verify_attention_ref(q, cache, L - 1, pads, fills, G, window), worst)
    return timing_record(ms, plain, library, flops, bytes_, PEAK_BF16_FLOPS)


def kernel_ms(torch, fn, n: int) -> dict:
    """{device kernel name: ms a call} of ``n`` calls of ``fn`` after one
    warm-up call (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
    by_kernel: dict[str, float] = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[evt.name] = by_kernel.get(evt.name, 0.0) + evt.time_range.elapsed_us()
    return {k: v / n / 1e3 for k, v in by_kernel.items()}


def timing_record(ms, plain, library, flops, bytes_, peak_flops) -> dict:
    t_ops = flops / peak_flops * 1e3
    t_bytes = bytes_ / PEAK_BYTES * 1e3
    return {
        "ms": ms, "plain_ms": plain, "library_ms": library,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
    }


# -- phase 6 ------------------------------------------------------------------


def agreement(texts: list, base: list) -> str:
    """How many texts equal their base text, and the characters each shares
    with it before the first difference (a near-tie flip shows as a long
    shared prefix, a fault as a short one)."""
    shared = [len(os.path.commonprefix([a, b])) for a, b in zip(texts, base)]
    same = sum(a == b for a, b in zip(texts, base))
    return f"{same}/{len(base)} equal, shared prefix chars {shared} of {[len(b) for b in base]}"


def reset_launches() -> None:
    """Sets every launch counter, and the evaluation timers, to 0."""
    from vnsum_tpu_torch.ops import decode_attention, flash_attention, int8_matmul, verify_attention

    flash_attention.launches = decode_attention.launches = verify_attention.launches = 0
    decode_attention.partials_launches = int8_matmul.launches = 0
    EVAL_SECONDS.update(embed=0.0, bertscore=0.0)


# wall seconds of the evaluator's sentence-embedding and BERTScore calls
# since the last reset (each ends in a host read of its result)
EVAL_SECONDS = {"embed": 0.0, "bertscore": 0.0}


def time_evaluation() -> None:
    """Wraps the evaluator's two embedding passes so that each adds its
    wall seconds to EVAL_SECONDS."""
    from vnsum_tpu_torch.eval import embedding, semantic

    def timed(key, fn):
        def call(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                EVAL_SECONDS[key] += time.perf_counter() - t0
        return call

    embedding.EmbeddingModel.sentence_embeddings = timed(
        "embed", embedding.EmbeddingModel.sentence_embeddings)
    semantic.bert_scores = timed("bertscore", semantic.bert_scores)


# the kernel wrappers' launch counters, as read_launches names them
COUNTERS = ("prefill", "decode", "verify", "partials", "gemv")


def read_launches() -> dict:
    from vnsum_tpu_torch.ops import decode_attention, flash_attention, int8_matmul, verify_attention

    return {"prefill": flash_attention.launches, "decode": decode_attention.launches,
            "verify": verify_attention.launches, "partials": decode_attention.partials_launches,
            "gemv": int8_matmul.launches}


def check_exact(path: str, launches: dict, need: dict,
                path_kernels=("prefill", "verify")) -> None:
    """Each kernel launched exactly as often as ``need`` says (a counter it
    leaves out: never), and each of ``path_kernels`` at least once."""
    want = {k: need.get(k, 0) for k in COUNTERS}
    if launches != want or not all(want[k] for k in path_kernels):
        raise AssertionError(f"{path}: launches {launches}, the engine record implies {want}")
    log(f"[launches] {path}: " + ", ".join(f"{k} {v}" for k, v in launches.items())
        + " (exactly the engine record's)")


@contextlib.contextmanager
def recorded_rows():
    """Collects the id rows TorchBackend detokenizes while it is open, each
    as a list, in the order generate detokenizes them: its length-sorted
    groups, not the prompts' order."""
    from vnsum_tpu_torch.backend.engine import TorchBackend

    rows: list = []
    detok = TorchBackend._detok

    def call(self, ids, extra_eos=()):
        rows.append(ids.tolist())
        return detok(self, ids, extra_eos)

    TorchBackend._detok = call
    try:
        yield rows
    finally:
        TorchBackend._detok = detok


def check_run(res: dict, docs, gen_dir: Path, approach: str = "mapreduce",
              model: str = "llama3.2:3b") -> tuple[dict, dict]:
    """A pipeline run's record: every document ok, every summary written,
    ROUGE, the sentence cosine and BERTScore computed (logged with the
    evaluation's wall since the last reset). Returns (record, {doc name:
    summary})."""
    rec = res["summarization"][model]
    if rec["successful"] != len(docs) or rec["failed"] != 0:
        raise AssertionError(f"documents: {rec['successful']} ok, {rec['failed']} failed")
    out_dir = Path(f"{gen_dir}_{approach}_{model.replace(':', '_').replace('.', '_')}")
    written = sorted(p.name for p in out_dir.glob("*.txt"))
    if written != [d.name for d in docs]:
        raise AssertionError(f"summaries written: {written}")
    ev = res["evaluation"][model]
    rouge = ev["rouge_scores"]
    if not all(math.isfinite(v) for v in rouge.values()):
        raise AssertionError(f"ROUGE not computed: {rouge}")
    for key, fields in (("semantic_similarity", ("mean", "std", "min", "max")),
                        ("bert_scores", ("bert_precision", "bert_recall", "bert_f1"))):
        got = ev.get(key, {})
        if sorted(got) != sorted(fields) or not all(math.isfinite(got[f]) for f in fields):
            raise AssertionError(f"{approach}: {key} not computed: {got}")
    log(f"[eval] {approach}: evaluation wall {sum(EVAL_SECONDS.values()):.3f}s (sentence "
        f"embeddings {EVAL_SECONDS['embed']:.3f}s, BERTScore {EVAL_SECONDS['bertscore']:.3f}s), "
        f"semantic_similarity {json.dumps(ev['semantic_similarity'])}, "
        f"bert_scores {json.dumps(ev['bert_scores'])}")
    EVAL_SECONDS.update(embed=0.0, bertscore=0.0)
    return rec, {p.name: p.read_text(encoding="utf-8") for p in out_dir.glob("*.txt")}


def check_captured(path: str, st: dict) -> None:
    """A captured run's steps: each captured group ran step 0 eagerly and
    replayed every later one, so the replays plus one per capture are all
    the decode steps, and some steps were replays."""
    if st["captured_steps"] <= 0 or (
            st["captured_steps"] + st["graph_captures"] != st["decode_steps"]):
        raise AssertionError(
            f"{path}: {st['captured_steps']} replayed steps and {st['graph_captures']} "
            f"captures for {st['decode_steps']} decode steps")


def captured_and_eager(torch, name: str, config_fn, label: str, max_new: int = 128,
                       eager: bool = True) -> dict:
    """The CLI's map-reduce over data/vi_eval with --models ``name``
    (``max_new`` new tokens, int8 cache, greedy), its decode steps
    captured; then, with ``eager``, the same run through PipelineRunner on
    a backend of ``config_fn()`` built with cuda_graphs=False (every step
    eager), once the CLI's model is freed. Each run: every document ok,
    every summary written, ROUGE and the embedding metrics computed; the
    captured run's replays plus one step a capture all its steps; the eager
    run the same decode steps, none replayed; the two runs' summaries
    byte-identical and their generated id rows (each run's detokenized
    rows, in order) equal. Logs both on ``[label]`` lines; returns the
    captured run's launches, record, engine stats, summaries, id rows and
    peak memory, and the eager run's backend (None without ``eager``)."""
    from vnsum_tpu_torch.backend.engine import TorchBackend
    from vnsum_tpu_torch.pipeline import cli
    from vnsum_tpu_torch.pipeline.runner import PipelineRunner

    docs = sorted((ROOT / "data/vi_eval/doc").glob("*.txt"))

    def cli_args(out: Path) -> list:
        return [
            "--approach", "mapreduce", "--models", name,
            "--docs-dir", str(ROOT / "data/vi_eval/doc"),
            "--summary-dir", str(ROOT / "data/vi_eval/summary"),
            "--generated-summaries-dir", str(out / "gen"),
            "--results-dir", str(out / "results"),
            "--logs-dir", str(out / "logs"),
            "--max-new-tokens", str(max_new), "--device", "cuda",
        ]

    rows: dict[str, list] = {}
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        with recorded_rows() as rows["captured"]:
            rc = cli.main(cli_args(Path(tmp)))
        wall = time.perf_counter() - t0
        launches = read_launches()
        if rc != 0:
            raise AssertionError(f"{label} CLI exited {rc}")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        res = json.loads(next((Path(tmp) / "results").glob("pipeline_results_*.json")).read_text())
        rec, summaries = check_run(res["results"], docs, Path(tmp) / "gen", model=name)
        rouge = res["results"]["evaluation"][name]["rouge_scores"]
        eng = res["results"]["engine"][name]
        check_captured(label, eng)
        decode_s = eng["phase_seconds"].get("decode", 0.0)
        log(f"[{label}] {rec['successful']}/{len(docs)} docs ok, {rec['failed']} failed, "
            f"chunks {rec['total_chunks']}, wall {wall:.2f}s, "
            f"prefill {eng['phase_seconds'].get('prefill', 0.0):.3f}s "
            f"({eng['prefill_forwards']} forwards), decode {decode_s:.3f}s ({eng['decode_steps']} "
            f"steps: {eng['graph_captures']} captured groups, {eng['captured_steps']} replays; "
            f"{1e3 * decode_s / max(eng['decode_steps'], 1):.2f} ms a step), generated tokens "
            f"{eng['generated_tokens']}, batches {eng['by_bucket']}, decode steps by batch "
            f"{eng['steps_by_bucket']}, peak memory {peak_gb:.2f} GB")
        log(f"[{label}] rouge {json.dumps(rouge)}")
        run = {"launches": launches, "rec": rec, "eng": eng, "summaries": summaries,
               "rows": rows["captured"], "peak_gb": peak_gb, "eager": None}
        if not eager:
            return run
        # the CLI's engine is unreachable once its run returns; collect it
        # before the control builds its own model (Phi-4's bf16 weights are
        # 29.3 GB)
        gc.collect()
        torch.cuda.empty_cache()

        cfg = cli.config_from_args(cli.build_parser().parse_args(cli_args(Path(tmp) / "eager")))
        controls = []

        def factory(_):
            controls.append(TorchBackend(
                config_fn(), batch_size=cfg.batch_size, max_new_tokens=cfg.max_new_tokens,
                cuda_graphs=False, device="cuda"))
            return controls[-1]

        t0 = time.perf_counter()
        runner = PipelineRunner(cfg, backend_factory=factory, device="cuda")
        with recorded_rows() as rows["eager"]:
            eager_res = runner.run()
        eager_wall = time.perf_counter() - t0
        if runner.failures:
            raise AssertionError(f"{label} eager control failures: {runner.failures}")
        _, eager_summaries = check_run(
            {"summarization": eager_res.summarization, "evaluation": eager_res.evaluation},
            docs, Path(tmp) / "eager" / "gen", model=name)
    est = controls[0].stats
    if est.captured_steps or est.graph_captures or est.decode_steps != eng["decode_steps"]:
        raise AssertionError(f"{label} eager control: {est.decode_steps} decode steps, "
                             f"{est.captured_steps} replayed, {est.graph_captures} captures")
    if eager_summaries != summaries:
        raise AssertionError(f"{label} summaries differ with capture on and off: "
                             + agreement([eager_summaries[d.name] for d in docs],
                                         [summaries[d.name] for d in docs]))
    if rows["eager"] != rows["captured"] or not rows["captured"]:
        raise AssertionError(f"{label} generated ids differ with capture on and off")
    ids = [t for r in rows["captured"] for t in r if t != controls[0].tok.pad_id]
    log(f"[{label}] eager control (cuda_graphs=False): wall {eager_wall:.2f}s, decode "
        f"{est.phase_seconds.get('decode', 0.0):.3f}s ({est.decode_steps} steps) against "
        f"{decode_s:.3f}s captured; summaries byte-identical ({len(docs)}/{len(docs)}, "
        f"{sum(map(len, summaries.values()))} bytes) and generated ids equal ({len(ids)} "
        f"non-pad ids in {len(rows['captured'])} rows, {len(set(ids))} distinct)")
    return {**run, "eager": controls[0]}


def phase_pipeline(torch) -> tuple[dict, dict]:
    """The plain map-reduce run on Llama-3.2-3B through the CLI and its
    eager control (captured_and_eager); K1 at least once a layer a prefill
    forward, K2 exactly once a layer a decode step. Returns (launches,
    summaries) of the captured run."""
    from vnsum_tpu_torch.models import llama32_3b

    n_layers = llama32_3b().n_layers
    run = captured_and_eager(torch, "llama3.2:3b", llama32_3b, "pipeline")
    launches, eng = run["launches"], run["eng"]
    check_exact("pipeline", launches, {
        "prefill": n_layers * eng["prefill_forwards"],
        "decode": n_layers * eng["decode_steps"]}, ("prefill", "decode"))
    return launches, run["summaries"]


# the dense logits gate of the Gemma3, Phi-4 and Qwen3-8B phases: the map
# batch's last-position logits through K1 (the engine's prefill, int8
# cache; and a bf16 cache) against the model's dense (windowed) forward on
# a bf16 cache, as max |K1 - dense| over the 7 document rows and the vocab
# divided by the largest |dense| logit. Both run the same bf16 weights; K1
# rounds p to bf16 against its running max and the dense path rounds the
# softmax, and the int8 cache rounds each K and V row to 1/254 of its
# largest value: bf16 and int8 roundings carried through 34-40 layers
# (Gemma3's sandwich norms rescale every layer's attention output to unit
# size). The limit is the spec gate's. The planted fault must exceed it:
# K1 at window 0 on every layer (the sliding window lost) where the config
# has one, else K1 with every row's pad 512 slots later (its first 512
# keys left out).
LOGITS_GATE_RTOL = 0.1


def logits_gate(torch, engine, docs, label: str) -> None:
    """The dense logits gate (LOGITS_GATE_RTOL) on ``engine``'s model. The
    dense forward runs a row at a time: its f32 scores of a row are [H, S,
    S], 2.7 GB at Phi-4's 40 heads, beside 29.3 GB of weights."""
    from vnsum_tpu_torch.backend.base import left_pad_batch
    from vnsum_tpu_torch.models.llama import (
        init_kv_cache,
        prefill_attention_mask,
        prefill_positions,
    )

    dev = torch.device("cuda")
    tok, model, cfg = engine.tok, engine.model, engine.cfg
    ids = tok.encode_batch([d.read_text(encoding="utf-8") for d in docs], add_bos=True)
    B, S = 8, 4096
    tokens_np, pads_np = left_pad_batch(ids, B, S, tok.pad_id)
    tokens = torch.from_numpy(tokens_np).to(dev)
    pads = torch.from_numpy(pads_np).to(dev)
    rows = len(docs)  # the filler row sees no key: K1 gives 0, dense a uniform average
    if cfg.sliding_window:
        fault = "every layer global (planted)"
    else:
        fault = "every row's first 512 keys left out (planted)"
    with torch.inference_mode():
        dense = torch.cat([
            model(tokens[r:r + 1], prefill_positions(pads[r:r + 1], S),
                  init_kv_cache(cfg, 1, S, device=dev), 0,
                  prefill_attention_mask(pads[r:r + 1], S, S), last_only=True)[:, -1].float()
            for r in range(rows)])
        scale = float(dense.abs().amax())
        windows = engine.windows
        out = {}
        for run, quantized in (("int8 cache", True), ("bf16 cache", False), (fault, True)):
            cache = init_kv_cache(cfg, B, S, quantized=quantized, device=dev)
            if run == fault and not cfg.sliding_window:
                got = model(tokens, prefill_positions(pads, S), cache, 0, None, last_only=True,
                            stacked_attention_fn=engine._prefill_stacked(
                                torch.clamp(pads + 512, max=S), 0))
            else:
                engine.windows = [0] * cfg.n_layers if run == fault else windows
                try:
                    got = engine._prefill_forward(tokens, pads, B, S, S, cache)
                finally:
                    engine.windows = windows
            out[run] = float((got[:rows, -1].float() - dense).abs().amax()) / scale
            del cache
    log(f"[{label}] map batch's last-position logits through K1 against the dense "
        f"{'windowed ' if cfg.sliding_window else ''}forward (bf16 cache, a row a "
        f"forward), share of the largest |logit| "
        f"{scale:.3f}: " + ", ".join(f"{k} {v:.3e}" for k, v in out.items())
        + f"; limit {LOGITS_GATE_RTOL:g}")
    bad = [k for k, v in out.items() if (v > LOGITS_GATE_RTOL) != ("planted" in k)]
    if bad:
        raise AssertionError(f"{label} logits gate: {bad} on the wrong side of the limit: {out}")
    torch.cuda.empty_cache()


def gemma_k2p_raises(torch) -> None:
    """K2p at head_dim 256, which waits for ROADMAP B4, refuses on the
    card before any launch: it never carries on through its plain version."""
    from vnsum_tpu_torch.ops.decode_attention import flash_decode_partials

    dev = torch.device("cuda")
    cache = make_cache(torch, 1, 2, GEMMA_KV, 256, GEMMA_HD, True, 5, dev)
    pads = torch.zeros(2, dtype=torch.int32, device=dev)
    q = rand_q(torch, (2, 1, GEMMA_KV * GEMMA_G, GEMMA_HD), 6, dev)
    before = read_launches()
    try:
        flash_decode_partials(q, cache, 0, pads, 100, GEMMA_G)
    except NotImplementedError as err:
        if "B4" not in str(err):
            raise AssertionError(f"gemma3 K2p: raised without naming B4: {err}")
    else:
        raise AssertionError("gemma3 K2p at head_dim 256 ran; it must raise (B4)")
    if read_launches() != before:
        raise AssertionError("gemma3: the refused K2p call launched a kernel")
    log("[gemma3] K2p raises NotImplementedError naming ROADMAP B4 at head_dim 256, with no "
        "launch")


# depth cuts of the Gemma3 phase and the int8 and W8A8 pipelines (at full
# width), which keep the whole run near 600 s, half its limit, on the slower
# card machines: with the serve phase the run took 554 s on one machine and
# 649-659 s on others; the cuts saved 27 s and 22 s of host-bound eager
# controls and captured runs (PERF.md §4)
GEMMA_LAYERS = 12
INT8_LAYERS = 7


def llama_int8_cut():
    from vnsum_tpu_torch.models import llama32_3b

    return llama32_3b(n_layers=INT8_LAYERS)


def gemma3_cut():
    """Gemma3-4B's config at GEMMA_LAYERS layers, every sixth global."""
    from vnsum_tpu_torch.models import gemma3_4b

    return gemma3_4b(n_layers=GEMMA_LAYERS,
                     layer_is_global=tuple((i + 1) % 6 == 0 for i in range(GEMMA_LAYERS)))


@contextlib.contextmanager
def registry_depth(factory, *names):
    """While open, the model registry's ``names`` build ``factory``'s
    config, so the CLI and PipelineRunner run the cut model."""
    from vnsum_tpu_torch.models import MODEL_REGISTRY

    saved = {n: MODEL_REGISTRY[n] for n in names}
    MODEL_REGISTRY.update(dict.fromkeys(names, factory))
    try:
        yield
    finally:
        MODEL_REGISTRY.update(saved)


def phase_gemma(torch) -> dict:
    """Gemma3-4B at its published width, cut to GEMMA_LAYERS of its 34 layers
    (registry_depth; dim 2560, 8/4
    heads, head_dim 256, intermediate 10240, vocab 262,208, tied head, a
    1024-slot window on the layers where (i + 1) % 6 != 0), random bf16
    weights from seed 0, byte tokenizer: map-reduce through the CLI and its
    eager control (captured_and_eager), K1 = n_layers x prefill forwards and
    K2 = n_layers x decode steps exactly, K2p = K3 = GEMV = 0, every batch a
    GEMMA_SHAPES batch that phase 3 checked; then the dense logits gate
    (logits_gate) on the control's model and K2p refused at head_dim
    256 (gemma_k2p_raises, B4); then, on the same model, path (a)
    (spec_path: the spec pipeline and its oracle, whose references are the
    one-shot's generated ids decoded unstripped), the one-step K3-against-K2
    gate (step_kernel_gate) and path (b) (slot_loop at fused_segments=4),
    all at GEMMA_PATH_NEW new tokens, each with exact launch counts. Random
    Gemma3 weights repeat a prompt's last token (the embedding, scaled by
    sqrt(dim), outweighs the layers' sum), whitespace after the reduce
    prompts, so the summaries strip to empty and the generated ids carry the
    comparison. Returns the launches of the captured CLI run, the spec path
    and the slot loop."""
    n_layers = GEMMA_LAYERS
    with registry_depth(gemma3_cut, "gemma3-4b", "gemma3:4b"):
        run = captured_and_eager(torch, "gemma3-4b", gemma3_cut, "gemma3")
    launches, eng = run["launches"], run["eng"]
    check_exact("gemma3", launches, {"prefill": n_layers * eng["prefill_forwards"],
                                     "decode": n_layers * eng["decode_steps"]},
                ("prefill", "decode"))
    check_batches("gemma3", eng)
    log(f"[gemma3] {eng['prefill_forwards']} prefill forwards, {eng['decode_steps']} decode "
        f"steps; generated row 0 begins {run['rows'][0][:8]}")
    t0 = time.perf_counter()
    logits_gate(torch, run["eager"], sorted((ROOT / "data/vi_eval/doc").glob("*.txt")), "gemma3")
    log(f"[gemma3] logits gate {time.perf_counter() - t0:.2f}s")
    gemma_k2p_raises(torch)
    model, summaries = run["eager"].model, run["summaries"]
    del run
    torch.cuda.empty_cache()
    # the spec path and the slot loop on the same model, through K3 at
    # head_dim 256 with each layer's window
    t0 = time.perf_counter()
    spec, backend, prompts, oneshot = spec_path(
        torch, "gemma3 spec", "gemma3-4b", {"model": model}, GEMMA_PATH_NEW, summaries)
    step_kernel_gate(torch, backend, prompts, "gemma3 spec")
    log(f"[gemma3] spec path, oracle and step gate {time.perf_counter() - t0:.2f}s")
    del backend
    t0 = time.perf_counter()
    slot = slot_loop(torch, model, prompts, oneshot, "gemma3 slot", GEMMA_PATH_NEW, (4,))
    log(f"[gemma3] slot loop {time.perf_counter() - t0:.2f}s")
    del model
    torch.cuda.empty_cache()
    return {k: launches[k] + spec[k] + slot[k] for k in COUNTERS}


def check_batches(label: str, eng: dict) -> None:
    """Every batch of a CLI run's engine record is a (B=8, S) of
    GEMMA_SHAPES, whose K1 and K2 phase 3 checked for the family."""
    batches = {tuple(int(part.split("=")[1]) for part in b.split(",")) for b in eng["by_bucket"]}
    if not batches <= {(8, S) for S in GEMMA_SHAPES}:
        raise AssertionError(f"{label}: batches {sorted(batches)} outside phase 3's "
                             f"{sorted(GEMMA_SHAPES)} at B=8")


def profile_captured_step(torch, engine, label: str) -> None:
    """One decode step of ``engine`` (its model, the one-shot path's step
    function) at the map batch's shape (B=8, from fill 4096, an int8 cache
    of C = S + 128), recorded as a CUDA graph and replayed, through
    profile_call: wall, device busy time and the kernels that take it, one
    K2 kernel of each pass per layer in the replay's trace."""
    from vnsum_tpu_torch.backend.capture import CapturedStep, decode_buffers, warm_up
    from vnsum_tpu_torch.core.config import GenerationConfig
    from vnsum_tpu_torch.models.llama import init_kv_cache

    dev, cfg = engine.device, engine.cfg
    B, S = 8, 4096
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    cur = torch.randint(0, 256, (B,), generator=gen, device=dev)
    cache = init_kv_cache(cfg, B, S + 128, quantized=True, device=dev)
    pads = torch.zeros(B, dtype=torch.int32, device=dev)
    # the buffers hold 128 steps; profile_call's ~45 replays fit
    buffers = decode_buffers(cur, torch.zeros(B, dtype=torch.bool, device=dev), 128, 0)
    gcfg = GenerationConfig()
    with torch.inference_mode():
        step = engine._decode_step(buffers, cache, pads, S, S + 128, gcfg, 0,
                                   engine._sampling_setup(gcfg))
        warm_up(lambda: step(0), dev)
        graph = CapturedStep(lambda: step(1))
        profile_call(torch, f"{label} captured decode step (B=8, from fill {S})", graph.replay,
                     10, cfg.n_layers, True, 0)
    del graph, step, cache, buffers
    torch.cuda.empty_cache()


def host_memory() -> str:
    """This process's host memory in GB: resident and the file-backed or
    shared part of it (a memory-mapped checkpoint's pages), from
    /proc/self/statm where the kernel reports it, and the process's peak
    resident (getrusage)."""
    import resource

    try:
        pages = Path("/proc/self/statm").read_text().split()
        size = os.sysconf("SC_PAGE_SIZE") / 1e9
        now = f"resident {int(pages[1]) * size:.2f} GB ({int(pages[2]) * size:.2f} file-backed)"
    except (OSError, IndexError, ValueError):
        now = "resident not reported"
    return f"{now}, peak {resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6:.2f} GB"


def write_phi_checkpoint(torch, model, cfg, out_dir: str) -> dict:
    """``model`` (float weights) written as a Phi-3/Phi-4 HF checkpoint:
    ``config.json`` of model_type phi3 and bf16 safetensors, one shard a
    layer and one for the embeddings, norm and head, with an index. Each
    layer's q/k/v rows go into ONE ``qkv_proj`` [(H + 2 KV) hd, D] and its
    gate/up rows into ``gate_up_proj`` [2 I, D], in that order, as
    Phi3ForCausalLM stores them. The JAX package has no writer of the fused
    layout, so it lives here. Returns the index it wrote."""
    from vnsum_tpu_torch.models.convert import INDEX_FILE, _to_hf, write_safetensors

    if model.quantized or cfg.dim != cfg.n_heads * cfg.head_dim or cfg.tie_embeddings or (
            cfg.qk_norm or cfg.sandwich_norms or cfg.sliding_window
            or cfg.use_llama3_rope_scaling or cfg.rope_linear_factor):
        raise ValueError("write_phi_checkpoint takes a float Phi-3 config: plain Llama math, "
                         "dim = n_heads * head_dim, an untied head")
    hf_cfg = {
        "architectures": ["Phi3ForCausalLM"], "model_type": "phi3",
        "vocab_size": cfg.vocab_size, "hidden_size": cfg.dim,
        "intermediate_size": cfg.intermediate, "num_hidden_layers": cfg.n_layers,
        "num_attention_heads": cfg.n_heads, "num_key_value_heads": cfg.n_kv_heads,
        "max_position_embeddings": cfg.max_seq_len,
        "original_max_position_embeddings": cfg.max_seq_len, "rms_norm_eps": cfg.norm_eps,
        "rope_theta": cfg.rope_theta, "rope_scaling": None, "hidden_act": "silu",
        "tie_word_embeddings": False, "torch_dtype": "bfloat16",
        "pad_token_id": 0, "bos_token_id": 1, "eos_token_id": 2,
    }
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(hf_cfg, f, indent=2)

    def bf16(t):
        return t.detach().to(torch.bfloat16).contiguous().cpu()

    p = model.layers
    shards = []
    for li in range(cfg.n_layers):
        pre = f"model.layers.{li}."
        shards.append({
            pre + "self_attn.qkv_proj.weight": bf16(torch.cat(
                [_to_hf(n, p[n][li], cfg) for n in ("wq", "wk", "wv")])),
            pre + "self_attn.o_proj.weight": bf16(_to_hf("wo", p["wo"][li], cfg)),
            pre + "mlp.gate_up_proj.weight": bf16(torch.cat(
                [_to_hf(n, p[n][li], cfg) for n in ("w_gate", "w_up")])),
            pre + "mlp.down_proj.weight": bf16(_to_hf("w_down", p["w_down"][li], cfg)),
            pre + "input_layernorm.weight": bf16(p["attn_norm"][li]),
            pre + "post_attention_layernorm.weight": bf16(p["mlp_norm"][li]),
        })
        if li < cfg.n_layers - 1:
            continue
        shards.append({"model.embed_tokens.weight": bf16(model.embed),
                       "model.norm.weight": bf16(model.final_norm),
                       "lm_head.weight": bf16(model.lm_head.t())})
    weight_map, total = {}, 0
    for i, tensors in enumerate(shards):
        name = f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
        total += write_safetensors(tensors, os.path.join(out_dir, name))
        weight_map.update(dict.fromkeys(tensors, name))
    index = {"metadata": {"total_size": total}, "weight_map": weight_map}
    with open(os.path.join(out_dir, INDEX_FILE), "w") as f:
        json.dump(index, f)
    return index


def phi_checkpoint(torch, prompts: list) -> None:
    """Phase 6b (5): Phi-4-14B at full width and 2 layers (random bf16
    weights from seed 0) written in the fused Phi layout
    (write_phi_checkpoint) and loaded with load_hf_checkpoint onto the
    card: the config equal to phi4_14b(n_layers=2), every parameter equal,
    and one map-batch prefill forward (the map ``prompts`` and an all-pad
    filler row, B=8, S=4096, int8 cache) giving the source model's logits
    exactly. Logs the write and load seconds, the load's peak device memory
    and the host's resident memory around it (the fused tensors are
    sliced as views of the memory-mapped shards: file pages, not copies).
    The checkpoint is deleted at the end, also on failure."""
    from vnsum_tpu_torch.backend.base import left_pad_batch
    from vnsum_tpu_torch.backend.engine import TorchBackend
    from vnsum_tpu_torch.models.convert import load_hf_checkpoint
    from vnsum_tpu_torch.models.llama import init_kv_cache, init_model, phi4_14b

    cfg = phi4_14b(n_layers=2)
    dev = torch.device("cuda")
    source = init_model(cfg, 0, dev)
    need = 2 * sum(t.numel() for t in source.parameters())  # bf16 bytes
    parent = Path(tempfile.gettempdir())
    if shutil.disk_usage(parent).free < 1.5 * need:
        parent = ROOT / "chip_weights"  # git-ignored
        parent.mkdir(exist_ok=True)
    ckpt = Path(tempfile.mkdtemp(prefix="vnsum_phi_", dir=parent))
    try:
        t0 = time.perf_counter()
        index = write_phi_checkpoint(torch, source, cfg, str(ckpt))
        write_s = time.perf_counter() - t0
        names = index["weight_map"]
        fused = [k for k in names if k.endswith(("qkv_proj.weight", "gate_up_proj.weight"))]
        if len(fused) != 2 * cfg.n_layers or any(k.endswith(("q_proj.weight", "up_proj.weight"))
                                                 and k not in fused for k in names):
            raise AssertionError(f"phi4 checkpoint: not the fused layout: {sorted(names)}")
        on_disk = sum(f.stat().st_size for f in ckpt.iterdir())
        log(f"[phi4 checkpoint] write_phi_checkpoint: {cfg.n_layers} layers at full width, "
            f"{len(set(names.values()))} shards + index, {index['metadata']['total_size']} "
            f"tensor bytes ({on_disk} on disk) written to {ckpt.parent} in {write_s:.2f}s "
            f"({on_disk / write_s / 1e9:.2f} GB/s)")

        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        host0 = host_memory()
        t0 = time.perf_counter()
        lcfg, loaded = load_hf_checkpoint(str(ckpt), device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        host1 = host_memory()
        peak = torch.cuda.max_memory_allocated()
        largest = max(2 * cfg.intermediate, cfg.vocab_size) * cfg.dim * 2  # bytes
        log(f"[phi4 checkpoint] load_hf_checkpoint: {load_s:.2f}s ({on_disk / load_s / 1e9:.2f} "
            f"GB/s), peak device memory {peak / 1e9:.2f} GB, {(peak - resident) / 1e9:.2f} GB "
            f"above the {resident / 1e9:.2f} GB resident before it (the source model); host "
            f"memory before it {host0}, after it {host1} (the largest tensor "
            f"{largest / 1e9:.2f} GB)")
        if lcfg != cfg:
            raise AssertionError(f"phi4 checkpoint: loaded config {lcfg} != {cfg}")
        src, got = source.state_dict(), loaded.state_dict()
        unequal = sorted(k for k in src if k not in got or not torch.equal(src[k], got[k]))
        if unequal or src.keys() != got.keys():
            raise AssertionError(f"phi4 checkpoint: parameters differ from the source: {unequal}")

        B, S, C = 8, 4096, 4096 + FAMILY_NEW
        logits = {}
        with torch.inference_mode():
            for name, m in (("source", source), ("loaded", loaded)):
                engine = TorchBackend(model=m, tokenizer="byte", batch_size=B,
                                      max_new_tokens=FAMILY_NEW, device="cuda")
                tok = engine.tok
                tokens_np, pads_np = left_pad_batch(tok.encode_batch(prompts, add_bos=True), B,
                                                    S, tok.pad_id)
                cache = init_kv_cache(cfg, B, C, quantized=True, device=dev)
                logits[name] = engine._prefill_forward(
                    torch.from_numpy(tokens_np).to(dev), torch.from_numpy(pads_np).to(dev), B, S,
                    C, cache)
                del engine, cache
        if not torch.equal(logits["source"], logits["loaded"]):
            raise AssertionError(
                "phi4 checkpoint: map-batch prefill logits differ: max |loaded - source| "
                f"{float((logits['loaded'] - logits['source']).abs().max()):.3e}")
        log(f"[phi4 checkpoint] config and all {len(src)} parameters equal the source's; "
            f"map-batch prefill forward (B={B}, S={S}, {len(prompts)} prompts): last-position "
            f"logits {tuple(logits['source'].shape)} of the loaded model equal the source's "
            "exactly")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    del source, loaded, logits
    torch.cuda.empty_cache()


def phase_phi4(torch) -> dict:
    """Phi-4-14B at its published width and depth (40 layers, dim 5120,
    40/10 heads: GQA group 4, head_dim 128, intermediate 17,920, vocab
    100,352, untied head), random bf16 weights from seed 0, byte tokenizer,
    FAMILY_NEW new tokens: (1) map-reduce through the CLI and its eager
    control (captured_and_eager), K1 = 40 x prefill forwards and K2 = 40 x
    decode steps exactly, K2p = K3 = GEMV = 0, every batch a GEMMA_SHAPES
    batch that phase 3 checked at group 4; (2) the dense logits gate
    (logits_gate, a row at a time) on the control's model, and one captured
    decode step profiled; (3) on the same model path (a) (spec_path: the
    spec pipeline and its oracle; K3 at Sq * G = 36 rows on every layer)
    and the one-step K3-against-K2 gate (step_kernel_gate), launches exact;
    (4) with that model freed, the CLI's map-reduce with --quantize
    (phase_int8_pipeline: the engine quantizes its bf16 init, as the JAX
    engine does; GEMV launches = gemv_need exactly), every document ok; (5)
    the fused checkpoint at 2 layers (phi_checkpoint). Returns the launches
    of (1), (3) and (4)."""
    from vnsum_tpu_torch.models import phi4_14b

    n_layers = phi4_14b().n_layers
    docs = sorted((ROOT / "data/vi_eval/doc").glob("*.txt"))
    run = captured_and_eager(torch, "phi4:14b", phi4_14b, "phi4", FAMILY_NEW)
    launches, eng = run["launches"], run["eng"]
    check_exact("phi4", launches, {"prefill": n_layers * eng["prefill_forwards"],
                                   "decode": n_layers * eng["decode_steps"]},
                ("prefill", "decode"))
    check_batches("phi4", eng)
    t0 = time.perf_counter()
    logits_gate(torch, run["eager"], docs, "phi4")
    profile_captured_step(torch, run["eager"], "phi4")
    log(f"[phi4] logits gate and profile {time.perf_counter() - t0:.2f}s")
    model, summaries = run["eager"].model, run["summaries"]
    del run
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    spec, backend, prompts, _ = spec_path(
        torch, "phi4 spec", "phi4:14b", {"model": model}, FAMILY_NEW, summaries)
    step_kernel_gate(torch, backend, prompts, "phi4 spec")
    log(f"[phi4] spec path, oracle and step gate {time.perf_counter() - t0:.2f}s")
    # no bf16 Phi-4 may stay resident while the int8 run builds its own
    del backend, model
    gc.collect()
    torch.cuda.empty_cache()
    int8 = phase_int8_pipeline(torch, False, "phi4:14b", FAMILY_NEW, eager=False,
                               path="phi4 int8 pipeline")
    t0 = time.perf_counter()
    phi_checkpoint(torch, prompts)
    log(f"[phi4] fused checkpoint {time.perf_counter() - t0:.2f}s")
    return {k: launches[k] + spec[k] + int8[k] for k in COUNTERS}


def phase_qwen3(torch) -> dict:
    """Qwen3-8B at its published width and depth (36 layers, dim 4096,
    32/8 heads: GQA group 4, head_dim 128, QK norm, intermediate 12,288,
    vocab 151,936, untied head), random bf16 weights from seed 0, byte
    tokenizer, FAMILY_NEW new tokens: the CLI's map-reduce, decode steps
    captured (captured_and_eager without the control: its capture and K3
    shapes are what Llama's and Phi-4's phases check), K1 = 36 x prefill
    forwards and K2 = 36 x decode steps exactly, every batch a GEMMA_SHAPES
    batch; then the dense logits gate (a row at a time) on the same seed's
    model. Returns the CLI run's launches."""
    from vnsum_tpu_torch.backend.engine import TorchBackend
    from vnsum_tpu_torch.models import qwen3_8b

    n_layers = qwen3_8b().n_layers
    run = captured_and_eager(torch, "qwen3:8b", qwen3_8b, "qwen3", FAMILY_NEW, eager=False)
    launches, eng = run["launches"], run["eng"]
    check_exact("qwen3", launches, {"prefill": n_layers * eng["prefill_forwards"],
                                    "decode": n_layers * eng["decode_steps"]},
                ("prefill", "decode"))
    check_batches("qwen3", eng)
    del run
    gc.collect()
    torch.cuda.empty_cache()
    engine = TorchBackend(qwen3_8b(), batch_size=8, max_new_tokens=FAMILY_NEW, device="cuda")
    logits_gate(torch, engine, sorted((ROOT / "data/vi_eval/doc").glob("*.txt")), "qwen3")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def gemv_need(eng: dict, n_layers: int, act: bool) -> int:
    """The GEMV launches a run's engine record implies: each decode step
    (B <= 8 rows) runs 4 a layer (q/k/v grouped, wo, gate/up grouped,
    w_down) and the head through the GEMV; each prefill forward (last_only,
    no chunking: one a batch) its head (B rows), and its projections too
    when B x S is within the GEMV's rows, never under W8A8 (s8 x s8
    products)."""
    from vnsum_tpu_torch.ops.int8_matmul import MAX_M

    need = (4 * n_layers + 1) * eng["decode_steps"]
    for bucket, n in eng["by_bucket"].items():
        B, S = (int(part.split("=")[1]) for part in bucket.split(","))
        need += n * (1 + (0 if act or B * S > MAX_M else 4 * n_layers))
    return need


def phase_int8_pipeline(torch, act: bool, name: str = "llama3.2:3b", max_new: int = 128,
                        eager: bool = True, path: str = "") -> dict:
    """[int8] (c), and (d) with ``act``: the CLI's map-reduce over
    data/vi_eval with --quantize (and --quantize-act) on model ``name``
    (Llama-3.2-3B at full width, main() cutting it to INT8_LAYERS layers
    through registry_depth; random bf16 weights from seed 0,
    quantized on the card, as the JAX engine quantizes its bf16 init),
    ``max_new`` new tokens, decode steps captured: every document ok, ROUGE
    and the embedding metrics computed, K1 = n_layers x prefill forwards,
    K2 = n_layers x decode steps and GEMV launches = gemv_need exactly, K2p
    = K3 = 0; then, with ``eager``, the same through PipelineRunner on a
    backend built with cuda_graphs=False, byte-identical summaries. Returns
    the captured run's launches."""
    from vnsum_tpu_torch.backend.engine import TorchBackend
    from vnsum_tpu_torch.models import MODEL_REGISTRY
    from vnsum_tpu_torch.pipeline import cli
    from vnsum_tpu_torch.pipeline.runner import PipelineRunner

    path = path or ("w8a8 pipeline" if act else "int8 pipeline")
    n_layers = MODEL_REGISTRY[name]().n_layers
    docs = sorted((ROOT / "data/vi_eval/doc").glob("*.txt"))

    def cli_args(out: Path) -> list:
        return [
            "--approach", "mapreduce", "--models", name,
            "--docs-dir", str(ROOT / "data/vi_eval/doc"),
            "--summary-dir", str(ROOT / "data/vi_eval/summary"),
            "--generated-summaries-dir", str(out / "gen"),
            "--results-dir", str(out / "results"),
            "--logs-dir", str(out / "logs"),
            "--max-new-tokens", str(max_new), "--device", "cuda", "--quantize",
        ] + (["--quantize-act"] if act else [])

    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        rc = cli.main(cli_args(Path(tmp)))
        wall = time.perf_counter() - t0
        launches = read_launches()
        if rc != 0:
            raise AssertionError(f"{path}: CLI exited {rc}")
        res = json.loads(next((Path(tmp) / "results").glob("pipeline_results_*.json")).read_text())
        if not (res["config"]["quantize"] and res["config"]["quantize_act"] == act):
            raise AssertionError(f"{path}: run record {res['config']}")
        rec, summaries = check_run(res["results"], docs, Path(tmp) / "gen", model=name)
        rouge = res["results"]["evaluation"][name]["rouge_scores"]
        eng = res["results"]["engine"][name]
        check_captured(path, eng)
        need = {"prefill": n_layers * eng["prefill_forwards"],
                "decode": n_layers * eng["decode_steps"], "verify": 0, "partials": 0,
                "gemv": gemv_need(eng, n_layers, act)}
        if (eng["decode_steps"] == 0 or launches != need
                or sum(eng["by_bucket"].values()) != eng["prefill_forwards"]):
            raise AssertionError(f"{path}: launches {launches}, the engine record "
                                 f"{eng['by_bucket']} ({eng['prefill_forwards']} prefill "
                                 f"forwards, {eng['decode_steps']} decode steps) needs {need}")
        log(f"[launches] {path}: " + ", ".join(f"{k} {v}" for k, v in launches.items())
            + " (each exactly as the engine record implies)")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        decode_s = eng["phase_seconds"].get("decode", 0.0)
        log(f"[int8] {path}: {rec['successful']}/{len(docs)} docs ok, wall {wall:.2f}s, "
            f"prefill {eng['phase_seconds'].get('prefill', 0.0):.3f}s "
            f"({eng['prefill_forwards']} forwards), decode {decode_s:.3f}s "
            f"({eng['decode_steps']} steps: {eng['graph_captures']} captured groups, "
            f"{eng['captured_steps']} replays, {1e3 * decode_s / eng['decode_steps']:.2f} ms a "
            f"step), generated tokens {eng['generated_tokens']}, batches {eng['by_bucket']}, "
            f"peak memory {peak_gb:.2f} GB")
        log(f"[int8] {path} rouge {json.dumps(rouge)}")
        if not eager:
            return launches
        gc.collect()  # the CLI's engine, before the control builds its own
        torch.cuda.empty_cache()

        cfg = cli.config_from_args(cli.build_parser().parse_args(cli_args(Path(tmp) / "eager")))
        controls = []

        def factory(_):
            controls.append(TorchBackend(
                MODEL_REGISTRY[name](), batch_size=cfg.batch_size,
                max_new_tokens=cfg.max_new_tokens, quantize=cfg.quantize,
                quantize_act=cfg.quantize_act, cuda_graphs=False, device="cuda"))
            return controls[-1]

        t0 = time.perf_counter()
        runner = PipelineRunner(cfg, backend_factory=factory, device="cuda")
        eager_res = runner.run()
        eager_wall = time.perf_counter() - t0
        if runner.failures:
            raise AssertionError(f"{path} eager control failures: {runner.failures}")
        _, eager_summaries = check_run(
            {"summarization": eager_res.summarization, "evaluation": eager_res.evaluation},
            docs, Path(tmp) / "eager" / "gen", model=name)
        est = controls[0].stats
        if (not controls[0].model.quantized or est.captured_steps or est.graph_captures
                or est.decode_steps != eng["decode_steps"]):
            raise AssertionError(f"{path} eager control: {est.decode_steps} decode steps, "
                                 f"{est.captured_steps} replayed, {est.graph_captures} captures")
        if eager_summaries != summaries:
            raise AssertionError(f"{path} summaries differ with capture on and off: "
                                 + agreement([eager_summaries[d.name] for d in docs],
                                             [summaries[d.name] for d in docs]))
    log(f"[int8] {path} eager control (cuda_graphs=False): wall {eager_wall:.2f}s, decode "
        f"{est.phase_seconds.get('decode', 0.0):.3f}s ({est.decode_steps} steps); summaries "
        f"byte-identical ({len(docs)}/{len(docs)})")
    return launches


# -- phase 6d -----------------------------------------------------------------


def phase_weights(torch, plain_summaries: dict) -> dict:
    """The pipeline phase's own weights written as an HF checkpoint and
    loaded back: equal config and parameters, equal logits on one map-batch
    prefill forward, and the map-reduce run on the loaded model
    byte-identical to the pipeline phase's captured run with K1 = 28 x
    prefill forwards and K2 = 28 x decode steps exactly. The card has no
    ``transformers``, so the checkpoint's own ``hf:`` tokenizer cannot load
    there: the run uses the byte tokenizer on TorchBackend(model=loaded),
    and the CPU tests cover the runner's tokenizer rule for
    ``--weights-dir``. The checkpoint is deleted at the end, also on
    failure. Returns the run's launches."""
    from vnsum_tpu_torch.backend.base import left_pad_batch
    from vnsum_tpu_torch.backend.engine import TorchBackend
    from vnsum_tpu_torch.models.convert import load_hf_checkpoint, save_hf_checkpoint
    from vnsum_tpu_torch.models.llama import init_kv_cache, init_model, llama32_3b
    from vnsum_tpu_torch.pipeline import cli
    from vnsum_tpu_torch.pipeline.runner import PipelineRunner
    from vnsum_tpu_torch.strategies import get_strategy

    cfg = llama32_3b()
    n_layers = cfg.n_layers
    dev = torch.device("cuda")
    docs = sorted((ROOT / "data/vi_eval/doc").glob("*.txt"))
    source = init_model(cfg, 0, dev)
    need = 2 * sum(p.numel() for p in source.parameters())  # bf16 bytes
    parent = Path(tempfile.gettempdir())
    if shutil.disk_usage(parent).free < 1.5 * need:
        parent = ROOT / "chip_weights"  # git-ignored
        parent.mkdir(exist_ok=True)
    ckpt = Path(tempfile.mkdtemp(prefix="vnsum_ckpt_", dir=parent))
    try:
        free = shutil.disk_usage(ckpt).free
        t0 = time.perf_counter()
        index = save_hf_checkpoint(source, cfg, str(ckpt))
        write_s = time.perf_counter() - t0
        shards = sorted(set(index["weight_map"].values()))
        on_disk = sum(f.stat().st_size for f in ckpt.iterdir())
        log(f"[weights] save_hf_checkpoint: {len(shards)} shards + index, "
            f"{index['metadata']['total_size']} tensor bytes ({on_disk} on disk) written to "
            f"{ckpt.parent} in {write_s:.2f}s ({on_disk / write_s / 1e9:.2f} GB/s); free space "
            f"there before {free / 1e9:.1f} GB")

        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        lcfg, loaded = load_hf_checkpoint(str(ckpt), device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        log(f"[weights] load_hf_checkpoint: {load_s:.2f}s ({on_disk / load_s / 1e9:.2f} GB/s), "
            f"peak device memory {peak / 1e9:.2f} GB, {(peak - resident) / 1e9:.2f} GB above "
            f"the {resident / 1e9:.2f} GB resident before it (the source model)")
        if lcfg != cfg:
            raise AssertionError(f"loaded config {lcfg} != {cfg}")
        src, got = source.state_dict(), loaded.state_dict()
        unequal = sorted(k for k in src if k not in got or not torch.equal(src[k], got[k]))
        if unequal or src.keys() != got.keys():
            raise AssertionError(f"loaded parameters differ from the source: {unequal}")

        # one map-batch prefill forward on each model, the same tokens
        argv = [
            "--approach", "mapreduce", "--models", "llama3.2:3b",
            "--docs-dir", str(ROOT / "data/vi_eval/doc"),
            "--summary-dir", str(ROOT / "data/vi_eval/summary"),
            "--generated-summaries-dir", str(ckpt.parent / f"{ckpt.name}_gen"),
            "--results-dir", str(ckpt.parent / f"{ckpt.name}_results"),
            "--logs-dir", str(ckpt.parent / f"{ckpt.name}_logs"),
            "--max-new-tokens", "128", "--device", "cuda",
        ]
        pcfg = cli.config_from_args(cli.build_parser().parse_args(argv))
        engines = {name: TorchBackend(model=m, tokenizer="byte", batch_size=8,
                                      max_new_tokens=128, device="cuda")
                   for name, m in (("source", source), ("loaded", loaded))}
        strategy = get_strategy("mapreduce", engines["source"], pcfg)
        prompts = [strategy.map_prompt.format(content=c)
                   for d in docs for c in strategy.splitter.split_text(d.read_text(encoding="utf-8"))]
        tok = engines["source"].tok
        tokens_np, pads_np = left_pad_batch(tok.encode_batch(prompts, add_bos=True), 8, 4096,
                                            tok.pad_id)
        tokens, pads = torch.from_numpy(tokens_np).to(dev), torch.from_numpy(pads_np).to(dev)
        logits = {}
        with torch.inference_mode():
            for name, engine in engines.items():
                cache = init_kv_cache(cfg, 8, 4096 + 128, quantized=True, device=dev)
                logits[name] = engine._prefill_forward(tokens, pads, 8, 4096, 4096 + 128, cache)
                del cache
        if not torch.equal(logits["source"], logits["loaded"]):
            raise AssertionError(
                "map-batch prefill logits differ: max |loaded - source| "
                f"{float((logits['loaded'] - logits['source']).abs().max()):.3e}")
        log(f"[weights] map-batch prefill forward (B=8, S=4096, {len(prompts)} prompts): "
            f"last-position logits {tuple(logits['source'].shape)} of the loaded model equal "
            "the source's exactly")
        del engines, logits, strategy
        torch.cuda.empty_cache()

        # the map-reduce run on the loaded model
        backends = []

        def factory(_):
            backends.append(TorchBackend(
                model=loaded, tokenizer="byte", batch_size=pcfg.batch_size,
                max_new_tokens=pcfg.max_new_tokens, device="cuda"))
            return backends[-1]

        reset_launches()
        t0 = time.perf_counter()
        runner = PipelineRunner(pcfg, backend_factory=factory, device="cuda")
        res = runner.run()
        wall = time.perf_counter() - t0
        launches = read_launches()
        if runner.failures:
            raise AssertionError(f"weights run failures: {runner.failures}")
        rec, summaries = check_run(
            {"summarization": res.summarization, "evaluation": res.evaluation},
            docs, ckpt.parent / f"{ckpt.name}_gen")
        st = backends[0].stats
        need = {"prefill": n_layers * st.prefill_forwards, "decode": n_layers * st.decode_steps,
                "verify": 0, "partials": 0, "gemv": 0}
        if st.decode_steps == 0 or launches != need:
            raise AssertionError(f"weights run: launches {launches}, the path needs {need}")
        check_captured("weights run", st.to_dict())
        log(f"[launches] weights run: " + ", ".join(f"{k} {v}" for k, v in launches.items()))
        if summaries != plain_summaries:
            names = sorted(plain_summaries)
            raise AssertionError("summaries of the loaded model differ from the pipeline "
                                 "phase's: " + agreement([summaries.get(n, "") for n in names],
                                                         [plain_summaries[n] for n in names]))
        log(f"[weights] map-reduce on the loaded model: {rec['successful']}/{len(docs)} docs "
            f"ok, wall {wall:.2f}s, {st.prefill_forwards} prefill forwards, {st.decode_steps} "
            f"decode steps ({st.captured_steps} replays); summaries byte-identical to the "
            f"pipeline phase's captured run ({len(docs)}/{len(docs)})")
    finally:
        for path in (ckpt, *ckpt.parent.glob(f"{ckpt.name}_*")):
            shutil.rmtree(path, ignore_errors=True)
    del source, loaded
    torch.cuda.empty_cache()
    return launches


# -- phase 6e -----------------------------------------------------------------


def bert_state_dict(params: dict) -> dict:
    """The encoder's parameters under HF BertModel names, with a ``bert.``
    prefix and a zero token-type table: the inverse of
    convert_hf_encoder_state_dict."""
    import torch

    from vnsum_tpu_torch.models.convert_encoder import _LAYER_KEYS

    sd = {
        "embeddings.word_embeddings.weight": params["tok_embed"],
        "embeddings.position_embeddings.weight": params["pos_embed"],
        "embeddings.token_type_embeddings.weight": torch.zeros_like(params["tok_embed"][:2]),
        "embeddings.LayerNorm.weight": params["embed_norm"]["w"],
        "embeddings.LayerNorm.bias": params["embed_norm"]["b"],
    }
    for hf_key, ours in _LAYER_KEYS.items():
        for li, w in enumerate(params["layers"][ours]):
            sd[f"encoder.layer.{li}.{hf_key}"] = w.t() if ours.startswith("w") else w
    return {f"bert.{k}": v for k, v in sd.items()}


def phase_encoder(torch) -> None:
    """The eval encoder at minilm_like()'s full shape on the card against
    the same random weights on the CPU; BERTScore of each text against
    itself; then the weights through the safetensors writer and
    load_hf_encoder, with equal config, parameters and scores."""
    from vnsum_tpu_torch.eval.embedding import EmbeddingModel, bert_scores
    from vnsum_tpu_torch.models.convert import write_safetensors
    from vnsum_tpu_torch.models.convert_encoder import load_hf_encoder
    from vnsum_tpu_torch.models.encoder import _map, minilm_like

    texts = [p.read_text(encoding="utf-8")
             for sub in ("summary", "doc") for p in sorted((ROOT / "data/vi_eval" / sub).glob("*.txt"))]
    card = EmbeddingModel(minilm_like(), seed=0, device="cuda")
    host = EmbeddingModel(minilm_like(), params=_map(card.params, lambda _, t: t.cpu()),
                          device="cpu")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    embs, mask = card.token_embeddings(texts)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want, want_mask = host.token_embeddings(texts)
    host_s = time.perf_counter() - t0
    err = float((embs.cpu() - want).abs().max())
    if not torch.equal(mask.cpu(), want_mask) or not err <= ENCODER_ATOL:
        raise AssertionError(f"encoder on the card against the CPU: max |diff| {err:.3e}, "
                             f"limit {ENCODER_ATOL:g}")
    log(f"[encoder] minilm_like (6 layers, dim 384, 12 heads) token embeddings of "
        f"{len(texts)} texts in one [{card.batch_size}, {card.max_len}] batch "
        f"({int(mask.sum())} tokens): card {card_s:.3f}s, CPU {host_s:.3f}s, max |card - cpu| "
        f"{err:.3e}, limit {ENCODER_ATOL:g} (err/limit {err / ENCODER_ATOL:.3f})")
    scores = bert_scores(card, texts, texts)
    worst = max(abs(1.0 - s.f1) for s in scores)
    if not worst <= 1e-5:
        raise AssertionError(f"BERTScore F1 of a text against itself is {worst:.3e} off 1")
    log(f"[encoder] BERTScore F1 of each of the {len(texts)} texts against itself: max "
        f"|1 - F1| {worst:.3e}, limit 1e-5")

    with tempfile.TemporaryDirectory() as tmp:
        cfg = card.cfg
        (Path(tmp) / "config.json").write_text(json.dumps({
            "architectures": ["BertModel"], "model_type": "bert",
            "vocab_size": cfg.vocab_size, "hidden_size": cfg.dim,
            "num_hidden_layers": cfg.n_layers, "num_attention_heads": cfg.n_heads,
            "intermediate_size": cfg.intermediate, "max_position_embeddings": cfg.max_len,
            "layer_norm_eps": cfg.norm_eps}))
        write_safetensors(bert_state_dict(card.params), str(Path(tmp) / "model.safetensors"))
        lcfg, lparams = load_hf_encoder(tmp, device="cuda")
    if lcfg != cfg:
        raise AssertionError(f"loaded encoder config {lcfg} != {cfg}")
    flat_src, flat_got = {}, {}
    _map(card.params, flat_src.__setitem__)
    _map(lparams, flat_got.__setitem__)
    unequal = sorted(k for k in flat_src if k not in flat_got
                     or not torch.equal(flat_src[k], flat_got[k]))
    if unequal or flat_src.keys() != flat_got.keys():
        raise AssertionError(f"loaded encoder parameters differ: {unequal}")
    loaded = EmbeddingModel(lcfg, params=lparams, device="cuda")
    if bert_scores(loaded, texts, texts[::-1]) != bert_scores(card, texts, texts[::-1]):
        raise AssertionError("BERTScore of the loaded encoder differs from the source's")
    log(f"[encoder] written under BERT names ({len(flat_src) + 1} tensors, token-type table "
        "zero) and loaded with load_hf_encoder: config and parameters equal, BERTScore equal")
    del card, loaded, lparams
    torch.cuda.empty_cache()


# -- phase 7 ------------------------------------------------------------------

STRATEGIES = ("mapreduce_critique", "iterative", "mapreduce_hierarchical", "skeleton")


def strategy_trees(docs, path: Path) -> None:
    """Writes the hierarchical run's tree JSON, built as its CPU test builds
    one: a document's title line is its Document node's text and its
    paragraphs sit under two Header nodes; every other document nests each
    paragraph under a sub-header of its own (depth 3, the rest depth 2);
    the last document is left out, so it takes the plain-text fallback."""
    trees = {}
    for i, doc in enumerate(docs[:-1]):
        title, _, body = doc.read_text(encoding="utf-8").partition("\n")
        paras = [p.strip() for p in body.split("\n\n") if p.strip()]
        halves = (paras[: len(paras) // 2], paras[len(paras) // 2 :])

        def leaf(k, text, nested=i % 2 == 0):
            node = {"type": "Paragraph", "text": text}
            return {"type": "Header", "text": f"Đoạn {k + 1}", "children": [node]} if nested else node

        trees[doc.name] = {"type": "Document", "text": title.strip(), "children": [
            {"type": "Header", "text": f"Phần {h + 1}",
             "children": [leaf(k, text) for k, text in enumerate(half)]}
            for h, half in enumerate(halves)]}
    path.write_text(json.dumps(trees, ensure_ascii=False), encoding="utf-8")


def critique_spy(get_strategy, seen: dict):
    """``get_strategy`` whose critique strategy counts its
    reduce-with-critique passes (one a collapse round, one for the
    token_max // 2 context pass, one final) into ``seen["passes"]`` and
    appends its StrategyResults to ``seen["results"]``."""

    def make(*args, **kw):
        strategy = get_strategy(*args, **kw)
        batch, reduce_pass = strategy.summarize_batch, strategy._reduce_with_critique_batch

        def summarize_batch(docs):
            out = batch(docs)
            seen["results"] += out
            return out

        def counted(*a, **k):
            seen["passes"] += 1
            return reduce_pass(*a, **k)

        strategy.summarize_batch, strategy._reduce_with_critique_batch = summarize_batch, counted
        return strategy

    return make


# the hierarchical runs' model: Llama-3.2-3B at full width and 4 of its
# 28 layers. At full depth the eager control alone took ~88 s of the run
# (1808 host-bound steps), at 14 layers 49.5 s; the cut keeps the whole run
# under half its time limit with Phi-4-14B's, Qwen3-8B's and the prefix
# cache's phases in it (646 s of command with 14 layers, PERF.md). The
# other three runs keep full depth: at 14 layers the random model's
# summaries are too short for critique's collapse round
HIERARCHICAL_LAYERS = 4


def phase_strategies(torch) -> dict:
    """The four other approaches through PipelineRunner (Llama-3.2-3B;
    hierarchical on its own model cut to HIERARCHICAL_LAYERS layers),
    captured, each held to K1 = n_layers x prefill forwards and K2 =
    n_layers x decode steps exactly and no K2p or K3 launch, every batch at
    a shape phase 3 checked; critique at token_max 16, which must take a
    collapse round and
    the context pass; then hierarchical, whose batches vary most in (B, S),
    on a backend built with cuda_graphs=False, whose summaries must be
    byte-identical. Logs the four captured runs' launches by kernel shape
    and returns the launches of the five runs."""
    from vnsum_tpu_torch.backend.engine import TorchBackend
    from vnsum_tpu_torch.models import llama32_3b
    from vnsum_tpu_torch.models.llama import init_model
    from vnsum_tpu_torch.pipeline import cli
    from vnsum_tpu_torch.pipeline import runner as runner_mod
    from vnsum_tpu_torch.pipeline.runner import PipelineRunner

    docs = sorted((ROOT / "data/vi_eval/doc").glob("*.txt"))
    dev = torch.device("cuda")
    models = {"full": init_model(llama32_3b(), 0, dev),
              "hierarchical": init_model(llama32_3b(n_layers=HIERARCHICAL_LAYERS), 0, dev)}
    total = dict.fromkeys(COUNTERS, 0)
    by_shape = {"prefill": {}, "decode": {}}
    checked = set(PIPELINE_SHAPES) | set(STRATEGY_SHAPES)

    def run(approach: str, out: Path, trees: Path, cuda_graphs="auto"):
        model = models["hierarchical" if approach == "mapreduce_hierarchical" else "full"]
        n_layers = model.cfg.n_layers
        argv = [
            "--approach", approach, "--models", "llama3.2:3b",
            "--docs-dir", str(ROOT / "data/vi_eval/doc"),
            "--summary-dir", str(ROOT / "data/vi_eval/summary"),
            "--generated-summaries-dir", str(out / "gen"),
            "--results-dir", str(out / "results"), "--logs-dir", str(out / "logs"),
            "--max-new-tokens", "128", "--chunk-size", "1024", "--device", "cuda",
        ]
        if approach == "mapreduce_hierarchical":
            argv += ["--tree-json", str(trees), "--max-depth", "2"]
        if approach == "mapreduce_critique":
            # the random model's summaries count ~5 whitespace tokens each
            argv += ["--token-max", "16"]
        cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
        backends = []

        def factory(_):
            backends.append(TorchBackend(
                model=model, batch_size=cfg.batch_size, max_new_tokens=cfg.max_new_tokens,
                cuda_graphs=cuda_graphs, device="cuda"))
            return backends[-1]

        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        runner = PipelineRunner(cfg, backend_factory=factory, device="cuda")
        seen = {"passes": 0, "results": []}
        make = runner_mod.get_strategy
        if approach == "mapreduce_critique":
            runner_mod.get_strategy = critique_spy(make, seen)
        try:
            res = runner.run()
        finally:
            runner_mod.get_strategy = make
        wall = time.perf_counter() - t0
        launches = read_launches()
        if runner.failures:
            raise AssertionError(f"{approach}: failures {runner.failures}")
        rec, summaries = check_run(
            {"summarization": res.summarization, "evaluation": res.evaluation},
            docs, out / "gen", approach)
        st = backends[0].stats
        path = f"{approach}{'' if cuda_graphs else ' eager control'}"
        check_exact(path, launches, {"prefill": n_layers * st.prefill_forwards,
                                     "decode": n_layers * st.decode_steps}, ("prefill", "decode"))
        unchecked = sorted(set(st.by_bucket) - checked)
        if unchecked:
            raise AssertionError(f"{path}: batches (B, S) {unchecked} are no shape phase 3 "
                                 "held K1 and K2 to their plain versions at")
        if approach == "mapreduce_critique":
            rounds = [r.rounds for r in seen["results"]]
            context = seen["passes"] - max(rounds, default=0) - 1
            if len(rounds) != len(docs) or max(rounds) < 1 or context != 1:
                raise AssertionError(f"{path}: collapse rounds {rounds}, context passes "
                                     f"{context}; token_max 16 must take both")
            log(f"[strategy] {path}: collapse rounds per document {rounds}, "
                f"the token_max // 2 context pass ran")
        for k in total:
            total[k] += launches[k]
        if sum(st.by_bucket.values()) != st.prefill_forwards:
            raise AssertionError(f"{path}: {st.prefill_forwards} prefill forwards for "
                                 f"batches {st.by_bucket}")
        if cuda_graphs:
            for (B, S), n in st.by_bucket.items():
                key = f"B={B},S={S}"
                by_shape["prefill"][key] = by_shape["prefill"].get(key, 0) + n_layers * n
            for (B, S), n in st.steps_by_bucket.items():
                key = f"B={B},C={S + 128}"
                by_shape["decode"][key] = by_shape["decode"].get(key, 0) + n_layers * n
        log(f"[strategy] {path}: {rec['successful']}/{len(docs)} docs ok, chunks "
            f"{rec['total_chunks']}, generate calls {st.calls}, prompts {st.prompts}, "
            f"batches {st.to_dict()['by_bucket']}, decode steps by batch "
            f"{st.to_dict()['steps_by_bucket']}, prefill forwards {st.prefill_forwards}, "
            f"decode steps {st.decode_steps} ({st.graph_captures} captures, "
            f"{st.captured_steps} replays), prefill {st.phase_seconds.get('prefill', 0.0):.3f}s, "
            f"decode {st.phase_seconds.get('decode', 0.0):.3f}s, wall {wall:.2f}s, "
            f"{60 * len(docs) / wall:.2f} documents/min, generated tokens "
            f"{st.generated_tokens}, peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        log(f"[strategy] {path} rouge "
            f"{json.dumps(res.evaluation['llama3.2:3b']['rouge_scores'])}")
        return st, summaries

    with tempfile.TemporaryDirectory() as tmp:
        trees = Path(tmp) / "trees.json"
        strategy_trees(docs, trees)
        for approach in STRATEGIES:
            st, summaries = run(approach, Path(tmp) / approach, trees)
            check_captured(approach, st.to_dict())
            if approach == "mapreduce_hierarchical":
                captured_steps, captured = st.decode_steps, summaries
        est, eager = run("mapreduce_hierarchical", Path(tmp) / "eager", trees, cuda_graphs=False)
    if est.captured_steps or est.graph_captures or est.decode_steps != captured_steps:
        raise AssertionError(f"hierarchical eager control: {est.decode_steps} decode steps, "
                             f"{est.captured_steps} replayed, {est.graph_captures} captures")
    if eager != captured:
        names = sorted(captured)
        raise AssertionError("hierarchical summaries differ with capture on and off: "
                             + agreement([eager[n] for n in names], [captured[n] for n in names]))
    log(f"[strategy] mapreduce_hierarchical: summaries byte-identical with capture on and off "
        f"({len(captured)}/{len(docs)})")
    log(f"[strategy] launches by shape, the four captured runs: K1 {by_shape['prefill']}, "
        f"K2 {by_shape['decode']}")
    del models
    torch.cuda.empty_cache()
    return total


# -- phase 7b -----------------------------------------------------------------

CHOICE_DIGITS = ["1", "2", "3", "4", "5"]
# phase 7b: score_choices' five gathered logits against an independent
# dense control on the same weights (flash=False: the dense attention over a
# bf16 cache, B = 1, no pad), as max |kernel - control| over a prompt's five
# logits divided by the largest |logit| of the control's whole row. The two
# paths differ by the int8 cache's rounding (per (position, head), up to
# 2^-8 of a row's absmax an element) against bf16's, K1's summation order
# and its p rounded to bf16 against the running max, and the projections
# run as [B x S]-row GEMMs at B = 8 or 2 against B = 1: bf16 roundings
# carried through 28 layers, like SPEC_LOGITS_RTOL's. The planted fault (the
# choice ids shifted by one, so the kernel path's logits are those of "2" to
# "6") moves them by the spread of a random model's logits, of the order of
# the largest one. Picks are gated only where the control's top-two margin
# among the five exceeds the limit: inside it, bf16 near-ties decide, and
# such picks are counted and logged.
JUDGE_LOGITS_RTOL = 0.1


def judge_prompts(summaries: dict) -> list:
    """The 14 judge prompts of data/vi_eval, as LLMJudge(constrained=True)
    sends them: per file (sorted), its correctness prompt (the summary and
    the reference) and its coherence prompt, each ending in the forced
    prefix."""
    from vnsum_tpu_torch.eval.geval import (
        COHERENCE_CRITERIA,
        CORRECTNESS_CRITERIA,
        _JUDGE_TEMPLATE,
        LLMJudge,
    )

    prompts = []
    for name in sorted(summaries):
        gen = summaries[name]
        ref = (ROOT / "data/vi_eval/summary" / name).read_text(encoding="utf-8")
        prompts.append(_JUDGE_TEMPLATE.format(
            criteria=CORRECTNESS_CRITERIA,
            body=f"Generated summary:\n{gen}\n\nReference summary:\n{ref}") + LLMJudge._FORCED_PREFIX)
        prompts.append(_JUDGE_TEMPLATE.format(
            criteria=COHERENCE_CRITERIA, body=f"Generated summary:\n{gen}") + LLMJudge._FORCED_PREFIX)
    return prompts


def recording_choices(engine) -> list:
    """Wraps ``engine._choice_logits`` so that every group score_choices
    dispatches appends (tokens, pads, S, gathered logits on the device):
    no host read beyond the engine's own."""
    groups = []
    inner = engine._choice_logits

    def spy(tokens, pads, S, ids):
        out = inner(tokens, pads, S, ids)
        groups.append((tokens, pads, S, out))
        return out

    engine._choice_logits = spy
    return groups


def logits_by_prompt(torch, engine, groups: list, prompts: list, out=None):
    """([prompts, 5] f32 gathered logits, [prompts] (B, S)) from recorded
    groups, each row matched to its prompt by its tokens (to every prompt
    with those tokens); with ``out``, the groups' rows overwrite a copy of
    it."""
    index = {}
    for i, ids in enumerate(engine.tok.encode_batch(prompts, add_bos=True)):
        index.setdefault(tuple(ids), []).append(i)
    out = (torch.full((len(prompts), len(CHOICE_DIGITS)), float("nan")) if out is None
           else out.clone())
    shapes = [None] * len(prompts)
    for tokens, pads, S, logits in groups:
        rows = logits.float().cpu()
        for r in range(len(pads)):
            if pads[r] < S:
                for i in index[tuple(tokens[r, pads[r]:].tolist())]:
                    out[i], shapes[i] = rows[r], (len(pads), S)
    if bool(out.isnan().any()):
        raise AssertionError("a judge prompt was scored in no group")
    return out, shapes


def control_rows(torch, engine, prompts: list):
    """The dense control: each prompt alone (B = 1, S = its length, no pad)
    through ``engine`` (flash=False), the last position's whole logits row:
    [prompts, vocab] f32 on the host."""
    import numpy as np

    every = torch.arange(engine.cfg.vocab_size, device=engine.device)
    rows = []
    with torch.inference_mode():
        for ids in engine.tok.encode_batch(prompts, add_bos=True):
            tokens = np.asarray([ids], dtype=np.int32)
            rows.append(engine._choice_logits(tokens, np.zeros(1, np.int32), len(ids), every)
                        .float().cpu()[0])
    return torch.stack(rows)


def judge_gate(torch, label: str, runs: dict, control, ids: list) -> dict:
    """Holds each run's [prompts, 5] logits to the control's: within
    JUDGE_LOGITS_RTOL of the control row's largest |logit|, and the same
    pick wherever the control's top-two margin exceeds that limit; the run
    "shifted ids" (the planted fault) must exceed it. Returns the counts
    of picks inside the margin."""
    want = control[:, ids]
    scale = control.abs().amax(dim=-1)
    top2 = want.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) / scale > JUDGE_LOGITS_RTOL
    ref_picks = want.argmax(dim=-1)
    failed, inside = [], {}
    for run, got in runs.items():
        err = ((got - want).abs().amax(dim=-1) / scale)
        picks = got.argmax(dim=-1)
        differ = (picks != ref_picks) & decided
        inside[run] = int((~decided).sum())
        log(f"[judge] {label} {run}: logits against the dense control, max |err| / max |logit| "
            f"per prompt {', '.join(f'{e:.3e}' for e in err.tolist())}; limit "
            f"{JUDGE_LOGITS_RTOL:g}; picks {picks.tolist()} (control {ref_picks.tolist()}), "
            f"{int(decided.sum())} decided beyond the margin, {inside[run]} inside it")
        if run == "shifted ids":
            if float(err.max()) <= JUDGE_LOGITS_RTOL:
                failed.append(f"planted fault '{run}' not seen ({float(err.max()):.3e})")
        elif float(err.max()) > JUDGE_LOGITS_RTOL or bool(differ.any()):
            failed.append(f"{run}: max {float(err.max()):.3e}, {int(differ.sum())} decided "
                          "picks differ")
    if failed:
        raise AssertionError(f"{label} against the dense control: " + "; ".join(failed))
    return inside


def choices_path(torch, label: str, engine, control_engine, prompts: list, n_layers: int) -> dict:
    """(a) on one engine: score_choices on the 14 prompts in one call and in
    7 calls of two, launch counts exact (K1 = 28 x prefill forwards, GEMV =
    one head a prefill forward on an int8 model, nothing else), every batch
    a JUDGE_SHAPES shape, the picks of the two runs equal beyond the margin,
    both held to the dense control with the fault planted in the script's
    own call. Returns the launches."""
    groups = recording_choices(engine)
    st = engine.stats
    fwd0, phase0 = st.prefill_forwards, st.phase_seconds.get("choice", 0.0)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    one = engine.score_choices(prompts, CHOICE_DIGITS)
    t1 = time.perf_counter()
    n_one = len(groups)
    pairs = []
    for i in range(0, len(prompts), 2):
        pairs += engine.score_choices(prompts[i:i + 2], CHOICE_DIGITS)
    t2 = time.perf_counter()
    launches = read_launches()
    forwards = st.prefill_forwards - fwd0
    need = {"prefill": n_layers * forwards, "decode": 0, "verify": 0, "partials": 0,
            "gemv": forwards if engine.model.quantized else 0}
    if launches != need or forwards != len(groups):
        raise AssertionError(f"{label}: launches {launches} for {forwards} prefill forwards "
                             f"({len(groups)} groups) need {need}")
    log(f"[launches] {label}: " + ", ".join(f"{k} {v}" for k, v in launches.items())
        + " (each exactly as the forwards imply)")
    logits_one, shapes_one = logits_by_prompt(torch, engine, groups[:n_one], prompts)
    logits_pairs, shapes_pairs = logits_by_prompt(torch, engine, groups[n_one:], prompts)
    outside = sorted({s for s in shapes_one + shapes_pairs} - set(JUDGE_SHAPES))
    if outside:
        raise AssertionError(f"{label}: batches (B, S) {outside} are no shape phase 3 held K1 "
                             "to its plain version at")
    del engine._choice_logits
    ids = [engine.tok.encode(c)[0] for c in CHOICE_DIGITS]
    # the planted fault: one group of the one-call run again, with the
    # choice ids shifted by one, in this script's own call
    tokens, pads, S, _ = groups[0]
    with torch.inference_mode():
        shifted = engine._choice_logits(tokens, pads, S,
                                        torch.tensor(ids, device=engine.device) + 1)
    logits_shifted, _ = logits_by_prompt(torch, engine, [(tokens, pads, S, shifted)], prompts,
                                         out=logits_one)
    control = control_rows(torch, control_engine, prompts)
    inside = judge_gate(torch, label, {"one call": logits_one, "7 calls of two": logits_pairs,
                                       "shifted ids": logits_shifted}, control, ids)
    scale = control.abs().amax(dim=-1)
    top2 = logits_one.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) / scale > JUDGE_LOGITS_RTOL
    differ = [i for i in range(len(prompts)) if one[i] != pairs[i] and bool(decided[i])]
    runs_err = float(((logits_one - logits_pairs).abs().amax(dim=-1) / scale).max())
    log(f"[judge] {label}: one call of {len(prompts)} against 7 calls of two: picks "
        f"{sum(a == b for a, b in zip(one, pairs))}/{len(prompts)} equal, logits max |diff| / "
        f"max |logit| {runs_err:.3e}, {int(decided.sum())} picks beyond the margin, "
        f"{len(prompts) - int(decided.sum())} inside it")
    if differ:
        raise AssertionError(f"{label}: the one-call and paired picks differ beyond the margin "
                             f"at prompts {differ}")
    tokens_total = sum(len(t) for t in engine.tok.encode_batch(prompts, add_bos=True))
    choice_s = st.phase_seconds.get("choice", 0.0) - phase0
    log(f"[judge] {label}: score_choices wall {1e3 * (t1 - t0):.1f} ms for one call of "
        f"{len(prompts)} prompts ({n_one} groups at "
        f"{sorted({(B, S) for (_, p, S, _) in groups[:n_one] for B in [len(p)]})}), "
        f"{1e3 * (t2 - t1) / 7:.1f} ms a call of two; "
        f"{1e6 * (t1 - t0) / tokens_total:.2f} us a prompt token in one call, "
        f"{1e6 * (t2 - t1) / tokens_total:.2f} in pairs; prefill (the choice phase) "
        f"{choice_s:.3f}s over {forwards} forwards; picks inside the margin {inside}")
    return launches


def phase_judge(torch, plain_summaries: dict) -> dict:
    """Phase 7b, the G-Eval judge on Llama-3.2-3B at full width and depth
    (random bf16 weights from seed 0, the pipeline phase's; byte tokenizer,
    int8 cache, batch 8): (a) score_choices on the 14 judge prompts, bf16
    and on the model's int8 copy (choices_path); (b) the constrained judge
    end to end through PipelineRunner over data/vi_eval; (c) the CLI's own
    judge, --judge-backend torch:llama3.2-3b, free decode of up to 256 new
    tokens (LLMJudge's budget), captured. Returns the launches of (a)-(c)."""
    import gc

    from vnsum_tpu_torch.backend.engine import TorchBackend
    from vnsum_tpu_torch.eval import LLMJudge
    from vnsum_tpu_torch.models import llama32_3b
    from vnsum_tpu_torch.models.llama import init_model
    from vnsum_tpu_torch.models.quant import quantize_model
    from vnsum_tpu_torch.pipeline import cli
    from vnsum_tpu_torch.pipeline import runner as runner_mod
    from vnsum_tpu_torch.pipeline.runner import PipelineRunner

    cfg3b = llama32_3b()
    n_layers = cfg3b.n_layers
    docs = sorted((ROOT / "data/vi_eval/doc").glob("*.txt"))
    prompts = judge_prompts(plain_summaries)
    lengths = [len(p.encode("utf-8")) + 1 for p in prompts]
    log(f"[judge] {len(prompts)} prompts of {min(lengths)}-{max(lengths)} tokens (byte "
        "tokenizer, BOS included)")
    total = dict.fromkeys(COUNTERS, 0)

    # (a) bf16 weights, then the int8 copy
    model = init_model(cfg3b, 0, torch.device("cuda"))
    engine = TorchBackend(model=model, batch_size=8, device="cuda")
    control = TorchBackend(model=model, flash=False, device="cuda")
    if not (engine.use_kernels and engine.quantize_kv) or control.use_kernels:
        raise AssertionError("the judge engine must run K1 over an int8 cache, the control not")
    for k, v in choices_path(torch, "score_choices bf16", engine, control, prompts,
                             n_layers).items():
        total[k] += v
    qmodel = quantize_model(model)
    qengine = TorchBackend(model=qmodel, batch_size=8, device="cuda")
    qcontrol = TorchBackend(model=qmodel, flash=False, device="cuda")
    for k, v in choices_path(torch, "score_choices int8", qengine, qcontrol, prompts,
                             n_layers).items():
        total[k] += v
    del qengine, qcontrol, qmodel, control
    torch.cuda.empty_cache()

    def cli_args(out: Path) -> list:
        return [
            "--approach", "mapreduce", "--models", "llama3.2:3b",
            "--docs-dir", str(ROOT / "data/vi_eval/doc"),
            "--summary-dir", str(ROOT / "data/vi_eval/summary"),
            "--generated-summaries-dir", str(out / "gen"),
            "--results-dir", str(out / "results"), "--logs-dir", str(out / "logs"),
            "--max-new-tokens", "128", "--device", "cuda",
        ]

    with tempfile.TemporaryDirectory() as tmp:
        # (b) the constrained judge end to end, on the summarizer's engine
        cfg = cli.config_from_args(cli.build_parser().parse_args(cli_args(Path(tmp) / "b")))
        cfg.evaluation.include_llm_eval = True
        judge = LLMJudge(engine, constrained=True)
        seen, evaluate = [], judge.evaluate
        score = engine.score_choices

        def scoring(ps, choices):
            seen.extend(ps)
            return score(ps, choices)

        engine.score_choices = scoring
        judge_wall = []

        def timed_evaluate(generated, references):
            t0 = time.perf_counter()
            try:
                return evaluate(generated, references)
            finally:
                judge_wall.append(time.perf_counter() - t0)

        judge.evaluate = timed_evaluate
        st = engine.stats
        fwd0, steps0 = st.prefill_forwards, st.decode_steps
        reset_launches()
        t0 = time.perf_counter()
        runner = PipelineRunner(cfg, backend_factory=lambda _: engine, llm_judge=judge,
                                device="cuda")
        res = runner.run()
        wall = time.perf_counter() - t0
        launches = read_launches()
        del engine.score_choices
        if runner.failures:
            raise AssertionError(f"constrained judge run: failures {runner.failures}")
        _, summaries = check_run({"summarization": res.summarization,
                                  "evaluation": res.evaluation}, docs, Path(tmp) / "b" / "gen")
        scores = res.evaluation["llama3.2:3b"]["llm_scores"]
        need = {"prefill": n_layers * (st.prefill_forwards - fwd0),
                "decode": n_layers * (st.decode_steps - steps0), "verify": 0, "partials": 0,
                "gemv": 0}
        if launches != need:
            raise AssertionError(f"constrained judge run: launches {launches} need {need}")
        means = [scores["llm_correctness_mean"], scores["llm_coherence_mean"]]
        if (scores["llm_successful_cases"] != len(docs) or scores["llm_failed_cases"] != 0
                or not all(math.isfinite(m) for m in means)):
            raise AssertionError(f"constrained judge: {scores}")
        if summaries != plain_summaries or seen != prompts:
            raise AssertionError("constrained judge run: its summaries or judge prompts differ "
                                 "from the pipeline phase's")
        for k in total:
            total[k] += launches[k]
        log(f"[launches] constrained judge run: " + ", ".join(f"{k} {v}" for k, v in
                                                              launches.items())
            + " (each exactly as the engine record implies)")
        log(f"[judge] constrained judge (b): {scores['llm_successful_cases']}/{len(docs)} "
            f"successful, {scores['llm_failed_cases']} failed, correctness mean "
            f"{scores['llm_correctness_mean']:.4f}, coherence mean "
            f"{scores['llm_coherence_mean']:.4f}; summaries and prompts equal the pipeline "
            f"phase's; judge wall {judge_wall[0]:.3f}s, {1e3 * judge_wall[0] / len(docs):.1f} ms "
            f"a judged file; run wall {wall:.2f}s")
        del runner, judge, engine, model
        gc.collect()
        torch.cuda.empty_cache()

        # (c) the CLI's own judge: a second random 3B model, free decode
        made, get_backend = [], runner_mod.get_backend

        def recording_backend(spec, **kw):
            made.append(get_backend(spec, **kw))
            return made[-1]

        runner_mod.get_backend = recording_backend
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        try:
            rc = cli.main(cli_args(Path(tmp) / "c") + ["--judge-backend", "torch:llama3.2-3b"])
        finally:
            runner_mod.get_backend = get_backend
        wall = time.perf_counter() - t0
        launches = read_launches()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if rc != 0:
            raise AssertionError(f"CLI judge run exited {rc}")
        saved = json.loads(next((Path(tmp) / "c" / "results").glob(
            "pipeline_results_*.json")).read_text())
        _, summaries = check_run(saved["results"], docs, Path(tmp) / "c" / "gen")
        scores = saved["results"]["evaluation"]["llama3.2:3b"]["llm_scores"]
        summarizer = saved["results"]["engine"]["llama3.2:3b"]
        (jst,) = [b.stats for b in made]
        jdict = jst.to_dict()
        check_captured("CLI judge", jdict)
        need = {"prefill": n_layers * (summarizer["prefill_forwards"] + jst.prefill_forwards),
                "decode": n_layers * (summarizer["decode_steps"] + jst.decode_steps),
                "verify": 0, "partials": 0, "gemv": 0}
        steps = {b: n / jst.by_bucket[b] for b, n in jst.steps_by_bucket.items()}
        if (launches != need or made[0].max_new_tokens != 64
                or any(n > JUDGE_NEW_TOKENS for n in steps.values())):
            raise AssertionError(f"CLI judge run: launches {launches} need {need}, decode steps "
                                 f"a group {steps} (at most {JUDGE_NEW_TOKENS})")
        outside = sorted(set(jst.by_bucket) - set(JUDGE_SHAPES))
        if outside:
            raise AssertionError(f"CLI judge: batches {outside} are no shape phase 3 checked")
        processed = scores["llm_successful_cases"] + scores["llm_failed_cases"]
        if scores["llm_total_cases_processed"] != len(docs) or processed != len(docs):
            raise AssertionError(f"CLI judge: {scores}")
        if summaries != plain_summaries:
            raise AssertionError("CLI judge run: its summaries differ from the pipeline phase's")
        for k in total:
            total[k] += launches[k]
    log(f"[launches] CLI judge run: " + ", ".join(f"{k} {v}" for k, v in launches.items())
        + " (each exactly as the two engine records imply)")
    log(f"[judge] CLI judge (c) --judge-backend torch:llama3.2-3b: "
        f"{scores['llm_successful_cases']} successful, {scores['llm_failed_cases']} failed of "
        f"{len(docs)}; judge generate calls {jst.calls}, batches {jdict['by_bucket']}, decode "
        f"steps {jst.decode_steps} ({jst.graph_captures} captures, {jst.captured_steps} "
        f"replays), prefill {jst.phase_seconds.get('prefill', 0.0):.3f}s, decode "
        f"{jst.phase_seconds.get('decode', 0.0):.3f}s, judge wall {jst.generate_seconds:.3f}s "
        f"({1e3 * jst.generate_seconds / len(docs):.1f} ms a judged file), generated tokens "
        f"{jst.generated_tokens}; run wall {wall:.2f}s; peak device memory with the second "
        f"model {peak_gb:.2f} GB; summaries equal the pipeline phase's")
    del made
    gc.collect()
    torch.cuda.empty_cache()
    return total


# -- phase 8 ------------------------------------------------------------------


def spec_path(torch, label: str, name: str, backend_kw: dict, max_new: int, base: dict):
    """Path (a) on model ``name``: map-reduce over data/vi_eval through
    PipelineRunner with TorchBackend(**backend_kw) at spec_k=8 and
    ``max_new`` new tokens, every group with references decoding
    speculatively through the verify kernel: every document ok, ROUGE and
    the embedding metrics computed; launches exactly n_layers x the engine
    record's prefill forwards (K1), verify steps (K3) and decode steps (K2:
    a group whose references are all empty decodes one-shot), K2p = GEMV =
    0. Then the oracle: the map batch one-shot, then again with the
    one-shot's generated ids, decoded without stripping, as references,
    which must accept drafts (multi-token steps, ragged per-row fills on the
    card), launches exact. Agreement with ``base`` (summaries by file) and
    with the one-shot outputs is logged, not gated: random bf16 weights give
    near-ties. Returns (launches, backend, map prompts, one-shot texts)."""
    from vnsum_tpu_torch.backend.base import trim_to_eos
    from vnsum_tpu_torch.backend.engine import TorchBackend
    from vnsum_tpu_torch.core.config import GenerationConfig, PipelineConfig
    from vnsum_tpu_torch.pipeline.runner import PipelineRunner
    from vnsum_tpu_torch.strategies import get_strategy

    docs = sorted((ROOT / "data/vi_eval/doc").glob("*.txt"))
    backends = []

    def factory(_):
        backends.append(TorchBackend(
            **backend_kw, generation=GenerationConfig(spec_k=8), max_new_tokens=max_new,
            batch_size=8, seed=0, device="cuda"))
        return backends[-1]

    with tempfile.TemporaryDirectory() as tmp:
        cfg = PipelineConfig(
            approach="mapreduce", models=[name], max_new_tokens=max_new,
            docs_dir=str(ROOT / "data/vi_eval/doc"),
            summary_dir=str(ROOT / "data/vi_eval/summary"),
            generated_summaries_dir=str(Path(tmp) / "gen"),
            results_dir=str(Path(tmp) / "results"), logs_dir=str(Path(tmp) / "logs"),
        )
        reset_launches()
        t0 = time.perf_counter()
        runner = PipelineRunner(cfg, backend_factory=factory, device="cuda")
        res = runner.run()
        wall = time.perf_counter() - t0
        launches = read_launches()
        if runner.failures:
            raise AssertionError(f"{label} pipeline failures: {runner.failures}")
        rec, summaries = check_run(
            {"summarization": res.summarization, "evaluation": res.evaluation},
            docs, Path(tmp) / "gen", model=name)
    backend = backends[0]
    st = backend.stats
    n_layers = backend.cfg.n_layers
    if st.spec_verify_steps == 0:
        raise AssertionError(f"{label}: the pipeline ran no verify step")
    check_exact(f"{label} pipeline", launches, {
        "prefill": n_layers * st.prefill_forwards, "verify": n_layers * st.spec_verify_steps,
        "decode": n_layers * st.decode_steps})
    names = sorted(summaries)
    same = agreement([summaries[n] for n in names], [base[n] for n in names])
    log(f"[{label}] pipeline {rec['successful']}/{len(docs)} docs ok, wall {wall:.2f}s, prefill "
        f"{st.phase_seconds.get('prefill', 0.0):.3f}s ({st.prefill_forwards} forwards), spec "
        f"decode {st.phase_seconds.get('spec_decode', 0.0):.3f}s ({st.spec_verify_steps} "
        f"verify steps, {1e3 * st.phase_seconds.get('spec_decode', 0.0) / st.spec_verify_steps:.1f}"
        f" ms a step), one-shot decode steps {st.decode_steps}, drafted "
        f"{st.spec_draft_tokens}, accepted {st.spec_accepted_tokens}, generated tokens "
        f"{st.generated_tokens}; against the plain run's summaries: {same} (not gated: random "
        "bf16 weights give near-ties)")
    log(f"[{label}] rouge {json.dumps(res.evaluation[name]['rouge_scores'])}")

    # the oracle: the map batch again, with its one-shot outputs as the
    # references, must accept drafts
    strategy = get_strategy("mapreduce", backend, cfg)
    prompts = [strategy.map_prompt.format(content=c)
               for d in docs for c in strategy.splitter.split_text(d.read_text(encoding="utf-8"))]
    reset_launches()
    forwards0, decode0 = st.prefill_forwards, st.decode_steps
    steps0, acc0 = st.spec_verify_steps, st.spec_accepted_tokens
    with recorded_rows() as rows:
        oneshot = backend.generate(prompts)
    if len(rows) != len(prompts):
        raise AssertionError(f"{label} oracle: {len(rows)} generated rows for {len(prompts)} "
                             "prompts")
    # generate detokenizes its groups in its own order (prompts sorted by
    # length, cut to the input budget): rebuild it to put each row back at
    # its prompt, then hold each row's text to the one-shot output there
    max_input = backend.cfg.max_seq_len - max_new
    lengths = [min(len(ids), max_input) for ids in backend.tok.encode_batch(prompts, add_bos=True)]
    order = sorted(range(len(prompts)), key=lengths.__getitem__)
    by_prompt = dict(zip(order, rows))
    eos = tuple(backend.gen_cfg.eos_ids)
    refs = [backend.tok.decode(trim_to_eos(by_prompt[i], backend.tok.eos_id, backend.tok.pad_id,
                                           eos)) for i in range(len(prompts))]
    misplaced = [i for i, (r, o) in enumerate(zip(refs, oneshot)) if r.strip() != o]
    if misplaced:
        raise AssertionError(f"{label} oracle: the generated rows of prompts {misplaced} do "
                             "not decode to their one-shot outputs")
    t0 = time.perf_counter()
    oracle = backend.generate(prompts, references=refs)
    wall = time.perf_counter() - t0
    oracle_launches = read_launches()
    report = backend.take_spec_report()
    steps, accepted = st.spec_verify_steps - steps0, st.spec_accepted_tokens - acc0
    if accepted <= 0:
        raise AssertionError(f"{label}: the oracle run accepted no draft: {report}")
    check_exact(f"{label} oracle", oracle_launches, {
        "prefill": n_layers * (st.prefill_forwards - forwards0), "verify": n_layers * steps,
        "decode": n_layers * (st.decode_steps - decode0)})
    log(f"[{label}] oracle: {len(prompts)} map prompts, {steps} verify steps, drafted "
        f"{sum(r.draft_tokens for r in report)}, accepted {accepted}, per-row accepted "
        f"{[r.accepted_tokens for r in report]}, spec wall {wall:.2f}s; against the "
        f"one-shot outputs: {agreement(oracle, oneshot)}")
    total = {k: launches[k] + oracle_launches[k] for k in launches}
    return total, backend, prompts, oneshot


def phase_spec_pipeline(torch, plain_summaries: dict):
    """Path (a) on Llama-3.2-3B (spec_path, 128 new tokens), a one-shot
    control at batch 4, then the gates on one verify forward against
    decode steps (spec_logits_gate) and on one decode step through K3
    against K2 (step_kernel_gate). Returns (launches, backend, map prompts,
    the map batch's one-shot outputs)."""
    from vnsum_tpu_torch.backend.engine import TorchBackend
    from vnsum_tpu_torch.models import llama32_3b

    total, backend, prompts, oneshot = spec_path(
        torch, "spec", "llama3.2:3b", {"model_config": llama32_3b()}, 128, plain_summaries)
    # control: the same one-shot generate at another batch shape, which
    # changes no math but the GEMM tiling; its agreement with the batch-8
    # run is what bf16 near-ties alone give
    control = TorchBackend(model=backend.model, batch_size=4, max_new_tokens=128,
                           device="cuda").generate(prompts)
    log(f"[spec] control: one-shot at batch 4 against batch 8: "
        f"{agreement(control, oneshot)}")
    spec_logits_gate(torch, backend, prompts)
    step_kernel_gate(torch, backend, prompts, "spec")
    return total, backend, prompts, oneshot


def spec_logits(torch, engine, tokens_np, pads_np, steps: int) -> dict:
    """The spec path's verify forward (K3) against single-token decode
    steps (K2) on one left-padded batch, the same weights and the same
    tokens: an int8 cache of C = S + 128 + steps prefilled once and kept
    aside, ``steps`` greedy decode steps on it, and one verify forward of
    their Sq = steps tokens at fill S on a copy of the kept cache. Returns
    {run: [per position, max |verify - decode| / max |decode|]} for the
    verify forward as it is ("sound") and with a fault planted here, in
    this function's own call: "split dropped" (K3 gets every row's pad 512
    slots later, so the first 512 keys a row sees are left out)."""
    from vnsum_tpu_torch.models.llama import init_kv_cache, verify_positions
    from vnsum_tpu_torch.ops.verify_attention import flash_spec_verify_attention

    model, dev, G = engine.model, engine.device, engine.cfg.q_per_kv
    windows = engine.windows
    B, S = tokens_np.shape
    tokens = torch.from_numpy(tokens_np).to(dev)
    pads = torch.from_numpy(pads_np).to(dev)
    cache = init_kv_cache(engine.cfg, B, S + 128 + steps, quantized=True, device=dev)
    last = engine._prefill_forward(tokens, pads, B, S, S + 128 + steps, cache)[:, -1]
    prefilled = {n: t.clone() for n, t in cache.items()}
    fed, want = [last.argmax(dim=-1)], []
    for t in range(steps):
        want.append(model(fed[-1][:, None], (S - pads.long() + t)[:, None], cache, S + t, None,
                          stacked_attention_fn=engine._decode_stacked(pads, S + t))[:, -1])
        fed.append(want[-1].argmax(dim=-1))
    del cache
    toks = torch.stack(fed[:steps], dim=1)
    fills = torch.full((B,), S, dtype=torch.int32, device=dev)
    out = {}
    for run, vpads in (("sound", pads), ("split dropped", pads + 512)):
        got = model(toks, verify_positions(pads, fills, steps),
                    {n: t.clone() for n, t in prefilled.items()}, fills, None,
                    stacked_attention_fn=lambda q, c, li: flash_spec_verify_attention(
                        q, c, li, vpads, fills, G, windows[li]))
        out[run] = [float((got[:, t] - want[t]).abs().amax() / want[t].abs().amax())
                    for t in range(steps)]
    return out


def spec_logits_gate(torch, engine, prompts: list) -> None:
    """The spec path's numbers against the plain decode path's
    (``spec_logits``) on the map batch (the 7 map prompts and an all-pad
    filler row, B=8, S=4096, 9 positions): the sound verify forward must
    stay within SPEC_LOGITS_RTOL at every position, and the planted fault
    must exceed it at some position."""
    from vnsum_tpu_torch.backend.base import left_pad_batch

    tok = engine.tok
    tokens, pads = left_pad_batch(tok.encode_batch(prompts, add_bos=True), 8, 4096, tok.pad_id)
    with torch.inference_mode():
        runs = spec_logits(torch, engine, tokens, pads, 9)
    failed = []
    for run, errs in runs.items():
        log(f"[spec] logits of one verify forward (K3, Sq=9) against 9 decode steps (K2), "
            f"{run}: {', '.join(f'{e:.3e}' for e in errs)}; limit {SPEC_LOGITS_RTOL:g}")
        if run == "sound" and max(errs) > SPEC_LOGITS_RTOL:
            failed.append(f"sound {max(errs):.3e}")
        if run != "sound" and max(errs) <= SPEC_LOGITS_RTOL:
            failed.append(f"planted fault '{run}' not seen ({max(errs):.3e})")
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError("verify logits against the decode path: " + "; ".join(failed))


def step_kernel_gate(torch, engine, prompts: list, label: str) -> None:
    """One greedy decode step on the map batch (the map prompts and an
    all-pad filler row, B=8, S=4096, an int8 cache of C = S + 128 prefilled
    once), run from two copies of the cache with the same [8 x 1]-row
    GEMMs: once through K2 at the shared fill S (``_decode_stacked``, the
    one-shot path's), once through K3 at Sq=1 with every row's fill S
    (``_verify_stacked``, the slot segment's), each layer at its window.
    The logits differ by the attention kernel alone; max |K3 - K2| over the
    rows and vocab over the largest |K2| logit must stay within
    STEP_KERNEL_RTOL, and K3 with every row's pad 512 slots later (a split
    dropped, planted in this function's own call) must exceed it."""
    from vnsum_tpu_torch.backend.base import left_pad_batch
    from vnsum_tpu_torch.models.llama import init_kv_cache, verify_positions
    from vnsum_tpu_torch.ops.verify_attention import flash_spec_verify_attention

    model, dev, cfg, tok = engine.model, engine.device, engine.cfg, engine.tok
    B, S = 8, 4096
    C = S + 128
    tokens_np, pads_np = left_pad_batch(tok.encode_batch(prompts, add_bos=True), B, S,
                                        tok.pad_id)
    tokens = torch.from_numpy(tokens_np).to(dev)
    pads = torch.from_numpy(pads_np).to(dev)
    fills = torch.full((B,), S, dtype=torch.int32, device=dev)
    positions = verify_positions(pads, fills, 1)
    windows, G = engine.windows, cfg.q_per_kv
    out = {}
    with torch.inference_mode():
        cache = init_kv_cache(cfg, B, C, quantized=True, device=dev)
        nxt = engine._prefill_forward(tokens, pads, B, S, C, cache)[:, -1].argmax(dim=-1)[:, None]
        k2 = model(nxt, positions, {n: t.clone() for n, t in cache.items()}, S, None,
                   stacked_attention_fn=engine._decode_stacked(pads, S))[:, -1].float()
        scale = float(k2.abs().amax())
        for run, fn in (("sound", engine._verify_stacked(pads, fills)),
                        ("split dropped (planted)", lambda q, c, li: flash_spec_verify_attention(
                            q, c, li, pads + 512, fills, G, windows[li]))):
            got = model(nxt, positions, {n: t.clone() for n, t in cache.items()}, fills, None,
                        stacked_attention_fn=fn)[:, -1].float()
            out[run] = float((got - k2).abs().amax()) / scale
            if run == "sound":
                out["argmax rows equal"] = int((got.argmax(-1) == k2.argmax(-1)).sum())
        del cache
    torch.cuda.empty_cache()
    log(f"[{label}] one decode step's logits through K3 (Sq=1, every fill {S}) against K2 "
        f"(fill {S}), the same GEMMs, {cfg.n_layers} layers, share of the largest |logit| "
        f"{scale:.3f}: sound {out['sound']:.3e} ({out['argmax rows equal']}/{B} argmax rows "
        f"equal), split dropped (planted) {out['split dropped (planted)']:.3e}; limit "
        f"{STEP_KERNEL_RTOL:g}")
    if out["sound"] > STEP_KERNEL_RTOL or out["split dropped (planted)"] <= STEP_KERNEL_RTOL:
        raise AssertionError(f"{label}: K3 against K2 in one decode step on the wrong side of "
                             f"the limit: {out}")


# -- phase 9 ------------------------------------------------------------------


def slot_loop(torch, model, prompts: list, oneshot: list, label: str, max_new: int,
              fused_runs=(1, 4)) -> dict:
    """Path (b) on ``model``: TorchBackend.start_slot_loop(slots=8,
    prompt_tokens=4096, max_new_tokens=max_new, segment_tokens=32) fed the
    map prompts in two waves and drained, at each of ``fused_runs``: every
    request completes, launches exactly n_layers x the join groups' prefill
    forwards (K1) and x the decode steps run (K3), no other kernel.
    Agreement with ``oneshot`` is logged, not gated. Returns the
    launches."""
    from vnsum_tpu_torch.backend.engine import TorchBackend

    n_layers = model.cfg.n_layers
    b = TorchBackend(model=model, batch_size=8, max_new_tokens=max_new, segment_tokens=32,
                     device="cuda")
    total = dict.fromkeys(COUNTERS, 0)
    texts = {}
    for fused in fused_runs:
        reset_launches()
        forwards0 = b.stats.prefill_forwards
        t0 = time.perf_counter()
        loop = b.start_slot_loop(slots=8, prompt_tokens=4096, max_new_tokens=max_new,
                                 fused_segments=fused)
        outs: dict = {}
        adm, rej = loop.admit([(i, prompts[i], None) for i in range(3)])
        if rej or len(adm) != 3:
            raise AssertionError(f"first wave: {len(adm)} admitted, {rej} rejected")
        pending = list(range(3, len(prompts)))
        for _ in range(64):
            for c in loop.step().completions:
                outs[c.key] = c.text
            if pending and loop.free:
                adm, rej = loop.admit([(i, prompts[i], None) for i in pending])
                if rej:
                    raise AssertionError(f"rejected {rej}")
                for a in adm:
                    pending.remove(a.key)
            if not pending and loop.active == 0:
                break
        wall = time.perf_counter() - t0
        launches = read_launches()
        if sorted(outs) != list(range(len(prompts))):
            raise AssertionError(f"{label}: completed {sorted(outs)} of {len(prompts)}")
        check_exact(f"{label} loop fused={fused}", launches, {
            "prefill": n_layers * (b.stats.prefill_forwards - forwards0),
            "verify": n_layers * loop.decode_steps})
        texts[fused] = [outs[i] for i in range(len(prompts))]
        log(f"[{label}] fused={fused}: {len(prompts)}/{len(prompts)} requests done, "
            f"{loop.refills} admitted, {loop.fused_dispatches} dispatches, {loop.segments} "
            f"segments, {loop.decode_steps} decode steps, wall {wall:.2f}s "
            f"({1e3 * wall / max(loop.decode_steps, 1):.1f} ms a step with the joins); against "
            f"the one-shot outputs: {agreement(texts[fused], oneshot)} (not gated)")
        loop.close()
        for k in total:
            total[k] += launches[k]
    if len(texts) > 1:
        log(f"[{label}] fused={fused_runs[-1]} texts equal fused={fused_runs[0]}'s: "
            f"{texts[fused_runs[-1]] == texts[fused_runs[0]]} (not gated)")
    return total


# -- phase 9b -----------------------------------------------------------------

# the prefix cache phase (ROADMAP A8): the arms' pool sizes and block width.
# 512 blocks hold the map batch's 321 cold blocks (1.94 GB at Llama-3.2-3B's
# int8 cache); 64 force evictions
CACHE_BLOCKS, CACHE_EVICT_BLOCKS, CACHE_BLOCK_TOKENS = 512, 64, 64
# a warm map batch's resume boundary: S = 4096 takes the grid's 512-slot
# steps, and a warm row's uncovered suffix is at most one 64-token block
RESUME_K = RESUME_OFFSETS[-1]
# the resume gate: the warm call's last-position logits (K1 at q_offset K
# over the gathered blocks; the [K, S) forward's GEMMs at [8 x 512] rows)
# against the cold call's (the whole prompt; [8 x 4096] rows), as max
# |warm - cold| over the document rows and the vocab divided by the largest
# |cold| logit. The prefix K/V are the same bits (the gathered-prefix
# gate); the forwards differ in the GEMMs' tiling: bf16 roundings carried
# through 28 layers (2.3e-2 on an H100), as in the spec gates, whose limit
# this is. The planted fault, the resume forward over a cache the gather
# never seeded (what a stale cache object would give), must exceed it; a
# gather one block late read 6.3e-2 on an H100, inside the limit: shifted
# positions and one zeroed block move random weights' logits little
# (PERF.md).
RESUME_LOGITS_RTOL = 0.1


def map_batch(backend) -> tuple[list, str]:
    """The map batch's prompts over data/vi_eval, built as the pipeline
    builds them (mapreduce's splitter and map template, on ``backend``'s
    tokenizer), and the template's header: the strategy's cache hint."""
    from vnsum_tpu_torch.core.config import PipelineConfig
    from vnsum_tpu_torch.strategies import get_strategy
    from vnsum_tpu_torch.strategies.prompts import template_header

    docs = sorted((ROOT / "data/vi_eval/doc").glob("*.txt"))
    cfg = PipelineConfig(approach="mapreduce", models=["llama3.2:3b"], max_new_tokens=128)
    strategy = get_strategy("mapreduce", backend, cfg)
    prompts = [strategy.map_prompt.format(content=c)
               for d in docs for c in strategy.splitter.split_text(d.read_text(encoding="utf-8"))]
    return prompts, template_header(strategy.map_prompt)


def spy_cache(torch, b) -> dict:
    """Hooks ``b``'s resume, group, prefill and pool-write steps; returns
    the record they fill: each group's prompt order and resume boundary K,
    each prefill's last-position logits by prompt and the K1 launches of
    resumed forwards. With ``state["keep"]``, each group's final cache rows
    by prompt ({prompt: (cache row, pad)}) and the row and slot each new
    pool block was copied from. With a kept call's record as
    ``state["reference"]`` (rows, writers), a resumed group checks its
    gathered slots: every block a row gathers, at slots pad_r + j * BLK,
    must equal bit for bit the reference call's cache where that block was
    copied from (the row that inserted it: a block shared by several
    prompts, as the template header's, is written once). Each resumed
    group appends (rows checked, rows whose slots [pad_r, K) also equal
    their own reference row's, blocks checked, blocks unequal)."""
    from vnsum_tpu_torch.ops import flash_attention

    state = {"groups": [], "K": [], "gathered": [], "logits": [], "caches": [],
             "writers": {}, "resume_launches": 0, "reference": None, "keep": False}
    prepare, run_group, forward = b._prepare_resume, b._run_group, b._prefill_forward
    store = b.prefix_cache.store if b.prefix_cache else None

    def spy_prepare(group, encoded, matches, pad_lens, B, S, max_new, *rest):
        res = prepare(group, encoded, matches, pad_lens, B, S, max_new, *rest)
        state["groups"].append(list(group))
        state["K"].append(res[0] if res else 0)
        if res is not None and state["reference"] is not None:
            K, cache = res[:2]
            rows, writers = state["reference"]
            BLK = store.block_tokens
            checked = own = blocks = bad = 0
            for r, i in enumerate(group):
                pad = int(pad_lens[r])
                if pad >= K:
                    continue
                checked += 1
                own += all(torch.equal(cache[n][:, r, :, pad:K], rows[i][0][n][:, :, pad:K])
                           for n in cache)
                for j, block in enumerate(matches[i].blocks[: -(-(K - pad) // BLK)]):
                    src, slot = writers[block]
                    lo = pad + j * BLK
                    blocks += 1
                    bad += not all(torch.equal(cache[n][:, r, :, lo:lo + BLK],
                                               rows[src][0][n][:, :, slot:slot + BLK])
                                   for n in cache)
            state["gathered"].append((checked, own, blocks, bad))
        return res

    def spy_run(*args, **kw):
        out, cache = run_group(*args, **kw)
        if state["keep"]:
            group = state["groups"][-1]
            state["caches"].append({i: ({n: t[:, r].clone() for n, t in cache.items()},
                                        int(args[1][r])) for r, i in enumerate(group)})
        return out, cache

    def spy_forward(tokens, pad_lens, B, S, C, cache, start=0):
        n0 = flash_attention.launches
        logits = forward(tokens, pad_lens, B, S, C, cache, start)
        if start:
            state["resume_launches"] += flash_attention.launches - n0
        if state["groups"]:
            state["logits"].append({i: logits[r, -1].float().clone()
                                    for r, i in enumerate(state["groups"][-1])})
        return logits

    b._prepare_resume, b._run_group, b._prefill_forward = spy_prepare, spy_run, spy_forward
    if store is not None:
        write_blocks = store.write_blocks

        def spy_write(cache, rows, slots, block_ids):
            if state["keep"]:
                group = state["groups"][-1]
                state["writers"].update({blk: (group[r], s)
                                         for r, s, blk in zip(rows, slots, block_ids)})
            return write_blocks(cache, rows, slots, block_ids)

        store.write_blocks = spy_write
    return state


def cache_arm(torch, b, label: str, prompts: list, hints, spy) -> dict:
    """One generate call of ``prompts`` on ``b``: launches exactly
    n_layers x the call's prefill forwards (K1) and decode steps (K2), no
    other kernel; its decode steps captured; with the prefix cache on, the
    per-prompt report, the hit and miss counters and the index's stats
    consistent with one another, no pin left. Logs hits, misses, prefill,
    gather and insert seconds, the pool's bytes, peak memory and K."""
    st, n_layers = b.stats, b.cfg.n_layers
    before = {k: getattr(st, k) for k in (
        "prefill_forwards", "decode_steps", "captured_steps", "graph_captures",
        "cache_hit_tokens", "cache_miss_tokens", "prompt_tokens")}
    phases = dict(st.phase_seconds)
    pc = b.prefix_cache
    lookups0 = pc.index.stats.lookups if pc else 0
    n_groups = len(spy["K"]) if spy else 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    texts = b.generate(prompts, cache_hints=None if hints is None else [hints] * len(prompts))
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    report = b.take_cache_report()
    d = {k: getattr(st, k) - v for k, v in before.items()}
    check_exact(f"prefix cache {label}", launches, {
        "prefill": n_layers * d["prefill_forwards"], "decode": n_layers * d["decode_steps"]},
        ("prefill", "decode"))
    check_captured(f"prefix cache {label}", {"captured_steps": d["captured_steps"],
                                             "graph_captures": d["graph_captures"],
                                             "decode_steps": d["decode_steps"]})
    secs = {k: st.phase_seconds.get(k, 0.0) - phases.get(k, 0.0)
            for k in ("prefill", "decode", "cache_gather", "cache_insert")}
    K = spy["K"][n_groups:] if spy else []
    stats = pc.stats_dict() if pc else None
    if pc is not None and (
            len(report) != len(prompts) or sum(report) != d["cache_hit_tokens"]
            or d["cache_hit_tokens"] + d["cache_miss_tokens"] != d["prompt_tokens"]
            or pc.index.stats.lookups - lookups0 != len(prompts) or stats["pinned_blocks"]):
        raise AssertionError(f"prefix cache {label}: report {report}, counters {d}, "
                             f"index {stats}")
    log(f"[cache] {label}: wall {wall:.2f}s, hit tokens {d['cache_hit_tokens']}, miss tokens "
        f"{d['cache_miss_tokens']}, per prompt {report}, K by group {K}, prefill "
        f"{secs['prefill']:.3f}s ({d['prefill_forwards']} forwards), gather "
        f"{secs['cache_gather']:.4f}s, insert {secs['cache_insert']:.4f}s, decode "
        f"{secs['decode']:.3f}s ({d['decode_steps']} steps, {d['captured_steps']} replays), "
        f"pool {json.dumps(stats)}, peak memory {peak_gb:.2f} GB")
    return {"texts": texts, "report": report, "launches": launches, "K": K, "stats": stats,
            "d": d}


def resume_logits_gate(torch, b, prompts: list, cold: dict, warm: dict) -> None:
    """The warm call's last-position logits against the cold call's, by
    prompt, within RESUME_LOGITS_RTOL of the largest |cold| logit; then one
    resumed prefill of the same prompts outside generate over a cache its
    gather left unseeded (planted here), which must exceed it."""
    pc = b.prefix_cache
    rows = sorted(cold)
    scale = max(float(cold[i].abs().max()) for i in rows)

    def share(got):
        return max(float((got[i] - cold[i]).abs().max()) for i in rows) / scale

    sound = share(warm)
    encoded = b.tok.encode_batch(prompts, add_bos=True)
    matches = [pc.match(ids, max_tokens=len(ids) - 1) for ids in encoded]
    gather = pc.store.gather
    try:
        group = sorted(range(len(encoded)),
                       key=lambda i: (len(encoded[i]) - matches[i].tokens, len(encoded[i])))
        tokens_np, pads_np, B, S = b._pack_group(group, encoded, b.max_new_tokens)
        pc.store.gather = lambda cache, ids, starts: cache
        # the class's methods: the spy's hooks count nothing of this call
        K, cache, _ = type(b)._prepare_resume(b, group, encoded, matches, pads_np, B, S,
                                              b.max_new_tokens)
        with torch.inference_mode():
            logits = type(b)._prefill_forward(b, 
                torch.from_numpy(tokens_np).to(b.device), torch.from_numpy(pads_np).to(b.device),
                B, S, S + b.max_new_tokens, cache, K)
        planted = share({i: logits[r, -1].float() for r, i in enumerate(group)})
        del cache, logits
    finally:
        pc.store.gather = gather
        for m in matches:
            pc.release(m)
    log(f"[cache] resume gate: the warm call's last-position logits against the cold call's, "
        f"{len(rows)} document rows, share of the largest |logit| {scale:.3f}: sound "
        f"{sound:.3e}, the gather dropped (planted, K={K}) {planted:.3e}; limit "
        f"{RESUME_LOGITS_RTOL:g}")
    if sound > RESUME_LOGITS_RTOL or planted <= RESUME_LOGITS_RTOL:
        raise AssertionError(f"resume gate on the wrong side of the limit: sound {sound}, "
                             f"planted {planted}")


def phase_prefix_cache(torch, model, plain_summaries: dict) -> tuple[dict, int]:
    """The prefix KV cache on Llama-3.2-3B at full width and depth (``model``:
    random bf16 weights from seed 0), byte tokenizer, int8 cache, 128 new
    tokens, over the map batch's prompts, the arms of the JAX package's A/B
    (scripts/bench_prefix_cache_ab.py): uncached (the cache off), cold (an
    empty 512-block pool, no hints), warm (the same call again: every row
    resumes at K = RESUME_K), hinted (a fresh pool, the map template's
    header as each prompt's hint, twice), post-eviction (a 64-block pool,
    cold then warm) and pipeline (map-reduce through PipelineRunner on the
    warm backend, the strategies' own hints). Gates: every arm's launches
    exact (cache_arm); every block the warm call gathers equals the cold
    call's cache where it was copied from, bit for bit; the resume logits
    gate (resume_logits_gate); hits only where
    the pool holds the prompts, evictions in the 64-block arm; every
    document of the pipeline arm ok. Then the slot loop with the cache
    (slot_cache_loop). Agreement with the uncached arm is logged, not
    gated. Returns (the phase's launches, K1 launches of resumed
    forwards)."""
    from vnsum_tpu_torch.backend.engine import TorchBackend
    from vnsum_tpu_torch.core.config import PipelineConfig
    from vnsum_tpu_torch.pipeline.runner import PipelineRunner

    def backend(blocks):
        return TorchBackend(model=model, batch_size=8, max_new_tokens=128, seed=0,
                            cache_blocks=blocks, cache_block_tokens=CACHE_BLOCK_TOKENS,
                            device="cuda")

    total = dict.fromkeys(COUNTERS, 0)

    def add(arm):
        for k in total:
            total[k] += arm["launches"][k]
        return arm

    uncached_b = backend(0)
    prompts, header = map_batch(uncached_b)
    lengths = [len(ids) for ids in uncached_b.tok.encode_batch(prompts, add_bos=True)]
    uncached = add(cache_arm(torch, uncached_b, "uncached", prompts, None, None))
    del uncached_b

    b = backend(CACHE_BLOCKS)
    spy = spy_cache(torch, b)
    spy["keep"] = True
    cold = add(cache_arm(torch, b, "cold", prompts, None, spy))
    spy["keep"] = False
    spy["reference"] = (spy["caches"][-1], spy["writers"])
    cold_logits = spy["logits"][-1]
    warm = add(cache_arm(torch, b, "warm", prompts, None, spy))
    warm_logits = spy["logits"][-1]
    spy["reference"] = None
    spy["caches"].clear()
    S, BLK = 4096, CACHE_BLOCK_TOKENS
    # distinct block-aligned prefixes: prompts share the template header's
    encoded = b.tok.encode_batch(prompts, add_bos=True)
    want_cold_blocks = len({tuple(ids[: (j + 1) * BLK]) for ids in encoded
                            for j in range((len(ids) - 1) // BLK)})
    want_warm = [max(RESUME_K - (S - n), 0) for n in lengths]
    problems = []
    if cold["report"] != [0] * len(prompts) or cold["stats"]["inserted_blocks"] != want_cold_blocks:
        problems.append(f"cold: report {cold['report']}, inserted "
                        f"{cold['stats']['inserted_blocks']} of {want_cold_blocks} blocks")
    if warm["K"] != [RESUME_K] or warm["report"] != want_warm or not sum(want_warm):
        problems.append(f"warm: K {warm['K']}, report {warm['report']} against {want_warm}")
    ((checked, own, blocks, bad),) = spy["gathered"] or [(0, 0, 0, -1)]
    if (checked != sum(1 for n in lengths if S - n < RESUME_K) or bad or not blocks
            or warm["stats"]["inserted_blocks"] != want_cold_blocks):
        problems.append(f"warm: {bad} of {blocks} gathered blocks differ from the cold cache "
                        f"where they were copied from ({checked} rows checked), inserted "
                        f"{warm['stats']['inserted_blocks']}")
    if problems:
        raise AssertionError("prefix cache: " + "; ".join(problems))
    log(f"[cache] gathered prefix: every block the warm call gathered ({blocks} in {checked} "
        f"rows) equals the cold call's cache where it was copied from, bit for bit (k, v, ks, "
        f"vs); {own} of {checked} rows equal their own cold row at slots [pad_r, {RESUME_K}) "
        f"(a block several prompts share, as the template header's, comes from the row that "
        f"inserted it); {sum(want_warm)} prompt tokens skipped of {sum(lengths)}")
    resume_logits_gate(torch, b, prompts, cold_logits, warm_logits)

    # the pipeline arm on the warm backend: its map call resumes
    docs = sorted((ROOT / "data/vi_eval/doc").glob("*.txt"))
    with tempfile.TemporaryDirectory() as tmp:
        cfg = PipelineConfig(
            approach="mapreduce", models=["llama3.2:3b"], max_new_tokens=128,
            docs_dir=str(ROOT / "data/vi_eval/doc"),
            summary_dir=str(ROOT / "data/vi_eval/summary"),
            generated_summaries_dir=str(Path(tmp) / "gen"),
            results_dir=str(Path(tmp) / "results"), logs_dir=str(Path(tmp) / "logs"))
        st = b.stats
        forwards0, steps0, hits0 = st.prefill_forwards, st.decode_steps, st.cache_hit_tokens
        K0 = len(spy["K"])
        reset_launches()
        t0 = time.perf_counter()
        runner = PipelineRunner(cfg, backend_factory=lambda _: b, device="cuda")
        res = runner.run()
        wall = time.perf_counter() - t0
        launches = read_launches()
        if runner.failures:
            raise AssertionError(f"prefix cache pipeline failures: {runner.failures}")
        _, summaries = check_run({"summarization": res.summarization,
                                  "evaluation": res.evaluation}, docs, Path(tmp) / "gen")
    check_exact("prefix cache pipeline", launches, {
        "prefill": b.cfg.n_layers * (st.prefill_forwards - forwards0),
        "decode": b.cfg.n_layers * (st.decode_steps - steps0)}, ("prefill", "decode"))
    add({"launches": launches})
    pipe_hits = st.cache_hit_tokens - hits0
    if pipe_hits <= 0 or b.prefix_cache.index.pinned_blocks:
        raise AssertionError(f"prefix cache pipeline: {pipe_hits} hit tokens, "
                             f"{b.prefix_cache.index.pinned_blocks} blocks left pinned")
    names = sorted(summaries)
    log(f"[cache] pipeline: {len(docs)}/{len(docs)} docs ok, wall {wall:.2f}s, hit tokens "
        f"{pipe_hits}, K by group {spy['K'][K0:]}, pool {json.dumps(b.prefix_cache_stats())}; "
        f"against the plain pipeline's summaries: "
        f"{agreement([summaries[n] for n in names], [plain_summaries[n] for n in names])} "
        "(not gated)")
    resumed = spy["resume_launches"]
    del b, spy
    gc.collect()

    hb = backend(CACHE_BLOCKS)
    hspy = spy_cache(torch, hb)
    hinted = [add(cache_arm(torch, hb, f"hinted {n}", prompts, header, hspy)) for n in (1, 2)]
    resumed += hspy["resume_launches"]
    log(f"[cache] hinted: the header's {len(hb.tok.encode(header, add_bos=True))} tokens, "
        f"{hinted[0]['stats']['inserted_blocks']} blocks inserted, K of the second call "
        f"{hinted[1]['K']} (0: the longest suffix leaves no 128-aligned skip)")
    del hb, hspy

    eb = backend(CACHE_EVICT_BLOCKS)
    espy = spy_cache(torch, eb)
    evicted = [add(cache_arm(torch, eb, f"post-eviction {arm}", prompts, None, espy))
               for arm in ("cold", "warm")]
    resumed += espy["resume_launches"]
    if evicted[-1]["stats"]["evictions"] <= 0 or (
            evicted[-1]["stats"]["blocks_used"] > CACHE_EVICT_BLOCKS):
        raise AssertionError(f"post-eviction: {evicted[-1]['stats']}")
    del eb, espy
    gc.collect()
    torch.cuda.empty_cache()

    base = uncached["texts"]
    log(f"[cache] agreement with the uncached arm (not gated: bf16 GEMM tiling across [8 x 512] "
        f"and [8 x 4096] rows can flip near-ties): cold {agreement(cold['texts'], base)}; warm "
        f"{agreement(warm['texts'], base)}; hinted {agreement(hinted[1]['texts'], base)}; "
        f"post-eviction warm {agreement(evicted[-1]['texts'], base)}")
    slot, slot_resumed = slot_cache_loop(torch, model, prompts, base[:3])
    for k in total:
        total[k] += slot[k]
    return total, resumed + slot_resumed


def slot_cache_loop(torch, model, prompts: list, oneshot: list) -> tuple[dict, int]:
    """The slot loop with the prefix cache (``slot_loop``'s pattern on a
    backend with a 512-block pool): one wave of 3 map prompts admitted and
    drained, then the same 3 admitted again, whose join group must resume
    (cached tokens > 0 at K = RESUME_K); launches exactly n_layers x the
    join groups' prefill forwards (K1) and x the decode steps (K3), no
    other kernel. Agreement with ``oneshot`` (the uncached arm's first 3
    outputs) is logged. Returns (launches, K1 launches of resumed
    forwards)."""
    from vnsum_tpu_torch.backend.engine import TorchBackend

    n_layers = model.cfg.n_layers
    b = TorchBackend(model=model, batch_size=8, max_new_tokens=128, segment_tokens=32,
                     cache_blocks=CACHE_BLOCKS, cache_block_tokens=CACHE_BLOCK_TOKENS,
                     device="cuda")
    spy = spy_cache(torch, b)
    reset_launches()
    t0 = time.perf_counter()
    loop = b.start_slot_loop(slots=8, prompt_tokens=4096, max_new_tokens=128)
    texts, cached = {}, {}
    for wave in (0, 1):
        adm, rej = loop.admit([((wave, i), prompts[i], None) for i in range(3)])
        if rej or len(adm) != 3:
            raise AssertionError(f"slot cache wave {wave}: {len(adm)} admitted, {rej} rejected")
        cached[wave] = [a.cached_tokens for a in adm]
        for _ in range(64):
            for c in loop.step().completions:
                texts[c.key] = c.text
            if loop.active == 0:
                break
    wall = time.perf_counter() - t0
    launches = read_launches()
    st = b.stats
    check_exact("slot loop with the prefix cache", launches, {
        "prefill": n_layers * st.prefill_forwards, "verify": n_layers * loop.decode_steps})
    if len(texts) != 6 or sum(cached[0]) or not all(cached[1]) or spy["K"][-1] != RESUME_K:
        raise AssertionError(f"slot loop with the prefix cache: {len(texts)} of 6 done, cached "
                             f"tokens {cached}, K by join {spy['K']}")
    waves = [[texts[(w, i)] for i in range(3)] for w in (0, 1)]
    log(f"[cache] slot loop: 2 waves of 3, cached tokens by join {cached}, K by join "
        f"{spy['K']}, hit tokens {st.cache_hit_tokens}, miss {st.cache_miss_tokens}, "
        f"{loop.decode_steps} decode steps, wall {wall:.2f}s, gather "
        f"{st.phase_seconds.get('cache_gather', 0.0):.4f}s, insert "
        f"{st.phase_seconds.get('cache_insert', 0.0):.4f}s; the resumed wave against the "
        f"first: {agreement(waves[1], waves[0])}; against the one-shot outputs: "
        f"{agreement(waves[1], oneshot)} (not gated)")
    loop.close()
    return launches, spy["resume_launches"]


# -- phase 9c -----------------------------------------------------------------

# the serving phase's decode budget and its server's coalescing window: the
# batch arm's 7 prompts arrive as one request, and the window holds the
# head for its company so they ride ONE engine batch, as the control does
SERVE_NEW = 64
SERVE_WAIT_S = 1.0
# /healthz fields probes parse (the JAX server's schema)
HEALTHZ_KEYS = {"status", "backend", "version", "started_at", "uptime_s", "queue_depth",
                "closed", "watchdog"}


def serve_request(method: str, url: str, payload=None, timeout: float = 600.0):
    """(status, decoded JSON or raw text) of one HTTP exchange; an HTTP
    error status is returned, not raised."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            status, raw = resp.status, resp.read()
    except urllib.error.HTTPError as e:
        status, raw = e.code, e.read()
    try:
        return status, json.loads(raw)
    except ValueError:
        return status, raw.decode(errors="replace")


def sse_events(raw: str) -> list:
    """(event, data) pairs of an SSE body."""
    events = []
    for frame in raw.split("\n\n"):
        name = data = None
        for line in frame.splitlines():
            if line.startswith("event: "):
                name = line[len("event: "):]
            elif line.startswith("data: "):
                data = json.loads(line[len("data: "):])
        if name:
            events.append((name, data))
    return events


@contextlib.contextmanager
def serving(backend, **kw):
    """A ServeState over ``backend`` behind the port's own make_server on
    127.0.0.1 (an ephemeral port), its base URL yielded with the state;
    on exit the server stops and the state drains (within 60 s, which is
    gated), and no scheduler or watchdog thread may be left alive."""
    import threading

    from vnsum_tpu_torch.serve.server import ServeState, make_server

    state = ServeState(backend, max_batch=8, **kw)
    server = make_server(state, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}", state
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        t0 = time.perf_counter()
        state.close(drain_timeout_s=60)
        closed_s = time.perf_counter() - t0
        left = [t.name for t in threading.enumerate()
                if t.name in ("vnsum-serve-scheduler", "vnsum-serve-watchdog") and t.is_alive()]
        if left or closed_s > 60 or thread.is_alive():
            raise AssertionError(f"serve close: {closed_s:.2f}s, threads left {left}")
        log(f"[serve] close: drained in {closed_s:.3f}s, no serving thread left")


def spy_loops(b) -> list:
    """Every slot loop ``b.start_slot_loop`` opens, in order."""
    loops = []
    start = b.start_slot_loop

    def spy(*args, **kw):
        loops.append(start(*args, **kw))
        return loops[-1]

    b.start_slot_loop = spy
    return loops


def serve_line(torch, arm: str, state, n: int, wall: float) -> None:
    """The arm's ``[serve]`` line: wall, TTFT and end-to-end quantiles from
    the server's own histograms, requests/s, segments and peak memory."""
    h = state.metrics.histograms_snapshot()
    snap = state.metrics.snapshot()
    q = {name: (h[name]["count"], h[name]["p50"], h[name]["p99"],
                h[name]["sum"] / max(h[name]["count"], 1))
         for name in ("ttft_seconds", "e2e_seconds")}
    log(f"[serve] {arm}: {n} requests in {wall:.3f}s ({n / wall:.2f} requests/s), TTFT "
        f"p50 {q['ttft_seconds'][1]:.4f}s p99 {q['ttft_seconds'][2]:.4f}s mean "
        f"{q['ttft_seconds'][3]:.4f}s ({q['ttft_seconds'][0]} anchored), e2e p50 "
        f"{q['e2e_seconds'][1]:.4f}s p99 {q['e2e_seconds'][2]:.4f}s mean "
        f"{q['e2e_seconds'][3]:.4f}s (bucket-derived quantiles), {snap.batches} engine batches, {snap.segments} "
        f"segments, {snap.refills} refills, cache hit tokens {snap.cache_hit_tokens}, "
        f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")


def concurrent_generate(base: str, payloads: list) -> list:
    """POST each payload to /v1/generate from its own thread, all at once;
    returns the (status, body) replies in payload order."""
    import threading

    replies = [None] * len(payloads)

    def run(i):
        replies[i] = serve_request("POST", base + "/v1/generate", payloads[i])

    threads = [threading.Thread(target=run, args=(i,), daemon=True) for i in range(len(payloads))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    if any(t.is_alive() for t in threads):
        raise AssertionError("serve: a client thread never got its reply")
    return replies


def phase_serve(torch, model) -> tuple[dict, int]:
    """The serving slice on Llama-3.2-3B (``model``: the spec phase's, full
    width and depth, random bf16 weights, int8 cache): arms (a)-(d) of the
    module docstring's 9c. Returns (the phase's launches, K1 launches of
    resumed forwards)."""
    from vnsum_tpu_torch.backend.engine import TorchBackend
    from vnsum_tpu_torch.serve.metrics import metric_names

    n_layers = model.cfg.n_layers
    total = dict.fromkeys(COUNTERS, 0)

    def backend(**kw):
        return TorchBackend(model=model, batch_size=8, max_new_tokens=SERVE_NEW,
                            segment_tokens=32, device="cuda", **kw)

    def add(launches):
        for k in total:
            total[k] += launches[k]

    control = backend()
    prompts, _hint = map_batch(control)
    oneshot = control.generate(prompts)
    del control

    # (a) batch dispatch: one request of the 7 prompts, one engine batch
    b = backend()
    with serving(b, max_wait_s=SERVE_WAIT_S) as (base, state):
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        forwards0, steps0 = b.stats.prefill_forwards, b.stats.decode_steps
        t0 = time.perf_counter()
        status, body = serve_request("POST", base + "/v1/generate",
                                     {"prompts": prompts, "max_new_tokens": SERVE_NEW})
        wall = time.perf_counter() - t0
        launches = read_launches()
        if status != 200:
            raise AssertionError(f"serve (a): HTTP {status}: {body}")
        texts = [c["text"] for c in body["completions"]]
        if texts != oneshot:
            raise AssertionError(f"serve (a): texts differ from the direct generate: "
                                 f"{agreement(texts, oneshot)}")
        check_exact("serve (a) batch dispatch", launches, {
            "prefill": n_layers * (b.stats.prefill_forwards - forwards0),
            "decode": n_layers * (b.stats.decode_steps - steps0)},
            path_kernels=("prefill", "decode"))
        add(launches)
        log(f"[serve] (a) batch: {len(texts)} texts byte-identical to the direct "
            f"generate, {state.metrics.snapshot().batches} engine batch(es)")
        serve_line(torch, "(a) batch", state, 1, wall)
        # (d) on the same server: a summarize request and the probe routes
        doc = sorted((ROOT / "data/vi_eval/doc").glob("*.txt"))[0]
        reset_launches()
        forwards0, steps0 = b.stats.prefill_forwards, b.stats.decode_steps
        t0 = time.perf_counter()
        status, body = serve_request("POST", base + "/v1/summarize", {
            "text": doc.read_text(encoding="utf-8"), "approach": "mapreduce",
            "max_new_tokens": SERVE_NEW})
        wall = time.perf_counter() - t0
        launches = read_launches()
        if status != 200 or not isinstance(body.get("summary"), str) or not body["llm_calls"]:
            raise AssertionError(f"serve (d): HTTP {status}: {body}")
        check_exact("serve (d) summarize", launches, {
            "prefill": n_layers * (b.stats.prefill_forwards - forwards0),
            "decode": n_layers * (b.stats.decode_steps - steps0)},
            path_kernels=("prefill", "decode"))
        add(launches)
        log(f"[serve] (d) summarize {doc.name}: 200, {body['num_chunks']} chunks, "
            f"{body['llm_calls']} LLM calls, summary {len(body['summary'])} chars, wall "
            f"{wall:.3f}s")
        status, health = serve_request("GET", base + "/healthz")
        ready = serve_request("GET", base + "/readyz")
        status_m, text = serve_request("GET", base + "/metrics")
        names = {line.split("{")[0].split(" ")[0] for line in text.splitlines()
                 if line and not line.startswith("#")}
        need = {"vnsum_serve_requests_total", "vnsum_serve_ttft_seconds_count",
                "vnsum_serve_e2e_seconds_count", "vnsum_serve_queue_depth"}
        if (status != 200 or not HEALTHZ_KEYS <= set(health) or health["backend"] != "torch"
                or ready != (200, {"status": "ready"}) or status_m != 200
                or not need <= names or not names <= {
                    f"{n}{suffix}" for n in metric_names()
                    for suffix in ("", "_bucket", "_sum", "_count")}):
            raise AssertionError(f"serve (d) probes: healthz {status} {sorted(health)}, "
                                 f"readyz {ready}, metrics {status_m} {sorted(need - names)}")
        log(f"[serve] (d) probes: /healthz {len(health)} keys, /readyz ready, /metrics "
            f"{len(names)} series, all registered")
    del b

    # (b) in flight: 7 concurrent requests and one stream
    b = backend()
    loops = spy_loops(b)
    with serving(b, max_wait_s=0.01, inflight=True, slots=8,
                 slot_prompt_tokens=4096) as (base, state):
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        forwards0 = b.stats.prefill_forwards
        t0 = time.perf_counter()
        payloads = [{"prompt": p, "max_new_tokens": SERVE_NEW, "request_id": f"b-{i}"}
                    for i, p in enumerate(prompts)]
        payloads.append({"prompt": prompts[0], "max_new_tokens": SERVE_NEW,
                         "stream": True, "request_id": "b-stream"})
        replies = concurrent_generate(base, payloads)
        wall = time.perf_counter() - t0
        launches = read_launches()
        if [s for s, _ in replies] != [200] * len(payloads):
            raise AssertionError(f"serve (b): statuses {[s for s, _ in replies]}")
        texts = [body["completions"][0]["text"] for _, body in replies[:-1]]
        events = sse_events(replies[-1][1])
        deltas = "".join(d["text"] for n, d in events if n == "delta")
        done = [d for n, d in events if n == "done"]
        if not done or deltas != done[0]["completions"][0]["text"]:
            raise AssertionError(f"serve (b): stream deltas {deltas!r} against done {done}")
        check_exact("serve (b) in flight", launches, {
            "prefill": n_layers * (b.stats.prefill_forwards - forwards0),
            "verify": n_layers * sum(loop.decode_steps for loop in loops)})
        add(launches)
        status, trace = serve_request("GET", base + "/debug/trace")
        spans = {e["name"] for e in trace["traceEvents"] if e.get("ph") == "X"}
        if not {"prefill", "decode_seg"} <= spans:
            raise AssertionError(f"serve (b): /debug/trace spans {sorted(spans)}")
        log(f"[serve] (b) in flight: {len(payloads)}/{len(payloads)} 200, {len(loops)} slot "
            f"loop(s), {sum(loop.decode_steps for loop in loops)} decode steps, the stream's "
            f"{sum(n == 'delta' for n, _ in events)} deltas equal its done text, trace spans "
            f"{sorted(spans)}; against (a): {agreement(texts, oneshot)} (not gated)")
        serve_line(torch, "(b) in flight", state, len(payloads), wall)
    del b, loops

    # (c) in flight with the prefix cache: two waves of the same 7 prompts
    b = backend(cache_blocks=CACHE_BLOCKS, cache_block_tokens=CACHE_BLOCK_TOKENS)
    loops = spy_loops(b)
    spy = spy_cache(torch, b)
    with serving(b, max_wait_s=0.01, inflight=True, slots=8,
                 slot_prompt_tokens=4096) as (base, state):
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        waves, joins = [], []
        for wave in (0, 1):
            k0 = len(spy["K"])
            replies = concurrent_generate(base, [
                {"prompt": p, "max_new_tokens": SERVE_NEW, "request_id": f"c{wave}-{i}"}
                for i, p in enumerate(prompts)])
            if [s for s, _ in replies] != [200] * len(prompts):
                raise AssertionError(f"serve (c) wave {wave}: {[s for s, _ in replies]}")
            waves.append([body["completions"][0]["text"] for _, body in replies])
            joins.append(spy["K"][k0:])
        wall = time.perf_counter() - t0
        launches = read_launches()
        st = b.stats
        check_exact("serve (c) in flight, prefix cache", launches, {
            "prefill": n_layers * st.prefill_forwards,
            "verify": n_layers * sum(loop.decode_steps for loop in loops)})
        add(launches)
        _, text = serve_request("GET", base + "/metrics")
        hits = [float(line.split()[-1]) for line in text.splitlines()
                if line.startswith("vnsum_serve_cache_hit_tokens_total")]
        if (not joins[1] or any(K != RESUME_K for K in joins[1]) or not hits or hits[0] <= 0
                or not spy["resume_launches"]):
            raise AssertionError(f"serve (c): K by join {joins}, /metrics hits {hits}, "
                                 f"resumed K1 launches {spy['resume_launches']}")
        log(f"[serve] (c) prefix cache: K by join {joins}, /metrics cache hit tokens "
            f"{hits[0]:.0f}, K1 launches at the resume shape {spy['resume_launches']}, hit "
            f"{st.cache_hit_tokens} miss {st.cache_miss_tokens} tokens; the second wave "
            f"against the first: {agreement(waves[1], waves[0])} (not gated)")
        serve_line(torch, "(c) prefix cache", state, 2 * len(prompts), wall)
    return total, spy["resume_launches"]


# -- phase 10 -----------------------------------------------------------------

ONE_CARD_CEILING = 16384  # Llama-3.2-3B's max_seq_len: the one-card engine's cut


def long_corpus(root: Path) -> list:
    """Two documents past the one-card ceiling, built from data/vi_eval:
    the seven documents concatenated and repeated to ~30,000 bytes, and in
    the reverse order to ~20,000 bytes; each one's reference is the
    concatenated summaries. Returns the document paths."""
    src = ROOT / "data/vi_eval"
    names = sorted(p.name for p in (src / "doc").glob("*.txt"))
    (root / "doc").mkdir(parents=True)
    (root / "summary").mkdir()
    docs = []
    for name, order, size in (("dai_30k.txt", names, 30000),
                              ("dai_20k.txt", names[::-1], 20000)):
        one = "\n\n".join((src / "doc" / n).read_text(encoding="utf-8").strip() for n in order)
        text = one
        while len(text.encode()) < size:
            text += "\n\n" + one
        text = text.encode()[:size].decode("utf-8", "ignore")
        ref = "\n".join((src / "summary" / n).read_text(encoding="utf-8").strip() for n in order)
        (root / "doc" / name).write_text(text, encoding="utf-8")
        (root / "summary" / name).write_text(ref, encoding="utf-8")
        docs.append(root / "doc" / name)
    return sorted(docs)


def phase_long_context(torch) -> dict:
    """Path (c): the truncated strategy through PipelineRunner over two
    documents past the one-card ceiling, on TorchLongContextBackend (one
    rank), its decode steps captured, with a bf16 and then an int8 prefill
    cache; then a bf16 run with cuda_graphs=False, whose summaries must be
    byte-identical to the captured bf16 run's; then the one-card engine on
    the same weights and prompts as a control (not gated). Returns the
    launches of the three gated runs."""
    import dataclasses

    from vnsum_tpu_torch.backend.engine import TorchBackend
    from vnsum_tpu_torch.backend.long_context import TorchLongContextBackend
    from vnsum_tpu_torch.core.config import PipelineConfig
    from vnsum_tpu_torch.models.llama import LlamaModel, init_model, llama32_3b
    from vnsum_tpu_torch.parallel import SeqGroup
    from vnsum_tpu_torch.pipeline.runner import PipelineRunner
    from vnsum_tpu_torch.strategies import TruncatedStrategy
    from vnsum_tpu_torch.strategies.prompts import TRUNCATED
    from vnsum_tpu_torch.text import clean_thinking_tokens

    cfg = llama32_3b()
    n_layers = cfg.n_layers
    max_context, max_new = 32768, 128
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    model = init_model(cfg, 0, dev)
    total = dict.fromkeys(COUNTERS, 0)
    texts = {}
    with tempfile.TemporaryDirectory() as tmp:
        docs = long_corpus(Path(tmp) / "corpus")
        for quantize_kv, graphs in ((False, "auto"), (True, "auto"), (False, False)):
            backends = []

            def factory(_):
                backends.append(TorchLongContextBackend(
                    model=model, group=SeqGroup(), tokenizer="byte", batch_size=2,
                    max_new_tokens=max_new, max_total_tokens=max_context + 1024,
                    quantize_kv=quantize_kv, cuda_graphs=graphs, device="cuda"))
                return backends[-1]

            run_dir = Path(tmp) / f"int8={quantize_kv},graphs={graphs}"
            pcfg = PipelineConfig(
                approach="truncated", models=["llama3.2:3b"], max_context=max_context,
                max_new_tokens=max_new, batch_size=2,
                docs_dir=str(Path(tmp) / "corpus/doc"),
                summary_dir=str(Path(tmp) / "corpus/summary"),
                generated_summaries_dir=str(run_dir / "gen"),
                results_dir=str(run_dir / "results"), logs_dir=str(run_dir / "logs"),
            )
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            t0 = time.perf_counter()
            runner = PipelineRunner(pcfg, backend_factory=factory, device="cuda")
            res = runner.run()
            wall = time.perf_counter() - t0
            launches = read_launches()
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            if runner.failures:
                raise AssertionError(f"long-context pipeline failures: {runner.failures}")
            rec, summaries = check_run(
                {"summarization": res.summarization, "evaluation": res.evaluation},
                docs, run_dir / "gen", approach="truncated")
            be = backends[0]
            st = be.stats
            # the prompts as the strategy built them: untruncated, each past
            # the one-card ceiling
            strategy = TruncatedStrategy(be, max_context=max_context, max_new_tokens=max_new)
            prompts = [TRUNCATED.format(text=strategy._truncate(d.read_text(encoding="utf-8")))
                       for d in docs]
            lengths = [len(be.tok.encode(p_, add_bos=True)) for p_ in prompts]
            if (sum(lengths) != st.prompt_tokens or min(lengths) <= ONE_CARD_CEILING
                    or any(strategy._truncate(d.read_text(encoding="utf-8"))
                           != d.read_text(encoding="utf-8") for d in docs)):
                raise AssertionError(
                    f"prompt lengths {lengths} (backend saw {st.prompt_tokens} tokens) must "
                    f"each pass {ONE_CARD_CEILING}, untruncated")
            label = f"int8={quantize_kv}" + ("" if graphs else ", eager")
            path = f"long context {label}"
            if st.by_bucket != {(2, max_context): 1}:
                raise AssertionError(f"{path}: batches {st.by_bucket}, expected one B=2 "
                                     f"S={max_context} group")
            need = {"prefill": n_layers * st.prefill_forwards, "decode": 0, "verify": 0,
                    "partials": n_layers * st.decode_steps, "gemv": 0}
            if st.decode_steps == 0 or launches != need:
                raise AssertionError(f"{path}: launches {launches}, the path needs {need}")
            if graphs:
                check_captured(path, st.to_dict())
            elif st.captured_steps or st.graph_captures:
                raise AssertionError(f"{path}: {st.captured_steps} steps replayed")
            log(f"[launches] {path}: " + ", ".join(f"{k} {v}" for k, v in launches.items()))
            rouge = res.evaluation["llama3.2:3b"]["rouge_scores"]
            log(f"[long] {label}: {rec['successful']}/{len(docs)} docs ok, prompt "
                f"tokens {lengths} (one-card ceiling {ONE_CARD_CEILING}), batches "
                f"{st.to_dict()['by_bucket']}, wall {wall:.2f}s, prefill "
                f"{st.phase_seconds.get('prefill', 0.0):.3f}s ({st.prefill_forwards} forward), "
                f"decode {st.phase_seconds.get('decode', 0.0):.3f}s ({st.decode_steps} steps, "
                f"{st.captured_steps} replayed, "
                f"{1e3 * st.phase_seconds.get('decode', 0.0) / st.decode_steps:.2f} ms a "
                f"step), generated tokens {st.generated_tokens}, peak memory {peak_gb:.2f} GB")
            log(f"[long] rouge {json.dumps(rouge)}")
            texts[quantize_kv, graphs] = [summaries[d.name] for d in docs]
            for k in total:
                total[k] += launches[k]
        if texts[False, False] != texts[False, "auto"]:
            raise AssertionError("long-context summaries differ with capture on and off: "
                                 + agreement(texts[False, False], texts[False, "auto"]))
        log("[long] bf16 summaries with capture off equal the captured run's: 2/2 "
            "byte-identical")
        log(f"[long] int8 prefill cache against bf16: "
            f"{agreement(texts[True, 'auto'], texts[False, 'auto'])} (not gated)")

        # control: the one-card engine, its ceiling raised to 40960 on the
        # same weights, bf16 cache, on the same prompts
        big = LlamaModel(dataclasses.replace(cfg, max_seq_len=40960), {
            "embed": model.embed.data, "final_norm": model.final_norm.data,
            "layers": {n: p_.data for n, p_ in model.layers.items()}})
        engine = TorchBackend(model=big, batch_size=2, max_new_tokens=max_new,
                              quantize_kv=False, device="cuda")
        t0 = time.perf_counter()
        control = [clean_thinking_tokens(t) for t in engine.generate(prompts)]
        wall = time.perf_counter() - t0
        log(f"[long] control: one-card engine at max_seq_len 40960 (batches "
            f"{engine.stats.to_dict()['by_bucket']}, wall {wall:.2f}s) against the long "
            f"path's bf16 run: {agreement(control, texts[False, 'auto'])} (not gated: bf16 "
            "near-ties)")
        long_logits_gate(torch, model, engine, prompts)
    del model, big, engine
    torch.cuda.empty_cache()
    return total


def long_logits(torch, model, engine, tokens_np, pads_np, steps: int) -> dict:
    """The long path's logits against the one-card engine's (K1 prefill
    into one cache of S + steps slots, then K2 decode steps over it) on one
    left-padded batch and the same weights: the prefill's last position,
    then ``steps`` decode steps, both paths fed the engine's greedy tokens.
    Returns {run: [per forward, max |long - engine| / max |engine|]} for
    the long path as it is ("sound") and with two faults planted here, in
    this function's own calls: "positions" (every decode position one too
    far) and "no decode cache" (the decode attends the prefill cache
    alone, K2p normalised). Its launches are not the path's."""
    from vnsum_tpu_torch.backend.long_context import long_prefill, make_long_decode_attention
    from vnsum_tpu_torch.models.llama import init_kv_cache
    from vnsum_tpu_torch.ops.decode_attention import flash_decode_partials

    dev = model.device
    B, S = tokens_np.shape
    G = model.cfg.q_per_kv
    tokens = torch.from_numpy(tokens_np).to(dev)
    pads = torch.from_numpy(pads_np).to(dev)
    pos0 = S - pads.long()
    cache = init_kv_cache(engine.cfg, B, S + steps, device=dev)
    want = [engine._prefill_forward(tokens, pads, B, S, S + steps, cache)[:, -1]]
    fed = []
    for t in range(steps):
        fed.append(want[-1].argmax(dim=-1))
        want.append(engine.model(
            fed[-1][:, None], (pos0 + t)[:, None], cache, S + t, None,
            stacked_attention_fn=engine._decode_stacked(pads, S + t))[:, -1])
    del cache
    last, prefill_cache = long_prefill(model, tokens, pads)
    merged = make_long_decode_attention(prefill_cache, pads, G)

    def prefill_only(q, c, li, t):
        o, _, l = flash_decode_partials(q, prefill_cache, li, pads, S - 1, G)
        return (o / l.clamp_min(1e-30)[..., None])[:, None].to(q.dtype)

    def rel(got, ref):
        return float((got - ref).abs().amax() / ref.abs().amax())

    out = {}
    for run, attention, shift in (("sound", merged, 0), ("positions", merged, 1),
                                  ("no decode cache", prefill_only, 0)):
        dec = init_kv_cache(model.cfg, B, steps, device=dev)
        errs = [rel(last, want[0])]
        for t, cur in enumerate(fed):
            logits = model(cur[:, None], (pos0 + t + shift)[:, None], dec, t, None,
                           stacked_attention_fn=lambda q, c, li: attention(q, c, li, t))
            errs.append(rel(logits[:, -1], want[t + 1]))
        out[run] = errs
    return out


def long_logits_gate(torch, model, engine, prompts: list) -> None:
    """Path (c)'s numbers against the one-card engine's (``long_logits``)
    at the path's shape (the two prompts, B=2, S=32768, 4 decode steps) and
    at a short one (their first 200 and 150 tokens, S=256, 16 steps, where
    a new token's K/V is a larger share of what a step attends). At each
    shape the sound long path must stay within its LONG_LOGITS_RTOL and
    each planted fault must exceed it at some forward."""
    from vnsum_tpu_torch.backend.base import left_pad_batch

    tok = engine.tok
    encoded = tok.encode_batch(prompts, add_bos=True)
    failed = []
    with torch.inference_mode():
        for shape, ids, S, steps in (
                ("path", encoded, 32768, 4),
                ("short", [encoded[0][:200], encoded[1][:150]], 256, 16)):
            tokens, pads = left_pad_batch(ids, len(ids), S, tok.pad_id)
            runs = long_logits(torch, model, engine, tokens, pads, steps)
            limit = LONG_LOGITS_RTOL[shape]
            for run, errs in runs.items():
                log(f"[long] logits against the one-card engine, {shape} shape (S={S}, "
                    f"{steps} steps), {run}: prefill {errs[0]:.3e}, decode steps "
                    f"{', '.join(f'{e:.3e}' for e in errs[1:])}; limit {limit:g}")
                worst = max(errs)
                if run == "sound" and worst > limit:
                    failed.append(f"{shape} sound {worst:.3e}")
                if run != "sound" and worst <= limit:
                    failed.append(f"{shape} planted fault '{run}' not seen ({worst:.3e})")
            torch.cuda.empty_cache()
    if failed:
        raise AssertionError("long path logits against the one-card engine: "
                             + "; ".join(failed))


# -- phase 11 -----------------------------------------------------------------


def profile_call(torch, name: str, fn, n: int, n_layers: int, captured: bool,
                 want_gemv: int) -> None:
    """One ``[profile]`` line for ``fn``: its first call's time, then its
    wall a call (CUDA events over ``n`` calls), the card's SM clock, power
    draw and clock-limit reasons (nvidia-smi) while it runs ``n`` more, and
    from one traced call (torch.profiler) the device's busy time, its
    kernel count and the kernels that take most of the time. A ``captured``
    step's trace must show exactly one K2 (or K2p) kernel of each pass per
    layer, and every trace ``want_gemv`` int8 GEMV kernels."""
    from torch.profiler import ProfilerActivity, profile

    # the first call on a fresh model and cache, as each pipeline
    # batch's first forward is: allocator growth, first GEMMs
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    first = (time.perf_counter() - t0) * 1e3
    wall = time_ms(torch, lambda i: fn(), n=n, reps=3)
    # the card's clock, power draw and clock-limit reasons, sampled
    # while it runs n more calls (a power-capped card clocks down)
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,clocks_throttle_reasons.active",
         "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
    )
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    card = smi.communicate(timeout=60)[0].strip()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_kernel: dict[str, float] = {}
    count = gemv_count = 0
    passes = {"flash_decode_split_kernel": 0, "flash_decode_merge_kernel": 0}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            count += 1
            us = evt.time_range.elapsed_us()
            by_kernel[evt.name] = by_kernel.get(evt.name, 0.0) + us
            for k in passes:
                passes[k] += k in evt.name
            gemv_count += "int8_gemv_kernel" in evt.name
    busy = sum(by_kernel.values()) / 1e3
    gemv_ms = sum(v for k, v in by_kernel.items() if "int8_gemv_kernel" in k) / 1e3
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    if captured and passes != dict.fromkeys(passes, n_layers):
        raise AssertionError(
            f"{name}: one replay's trace shows {count} device ops and the decode "
            f"kernel's passes {passes}, expected {n_layers} of each")
    if gemv_count != want_gemv:
        raise AssertionError(f"{name}: the trace shows {gemv_count} int8 GEMV "
                             f"kernels, expected {want_gemv}")
    busy_txt = (f"device busy {busy:.3f} ms ({100 * busy / wall:.1f}% of wall)"
                if count else "device busy not measured (no device events)")
    gemv_txt = (f", int8 GEMV {gemv_count} kernels {gemv_ms:.3f} ms of device time"
                if gemv_count else "")
    log(f"[profile] {name}: first call {first:.3f} ms, then wall {wall:.3f} ms, "
        f"{busy_txt}, {count} device ops, decode kernel passes {passes}{gemv_txt}; "
        f"card (SM clock, power, limit reasons) {card}; top: "
        + "; ".join(f"{k[:60]} {v / 1e3:.3f} ms" for k, v in top))


def phase_profile(torch) -> None:
    """Where the main path's time goes, at the map batch's shape (B=8,
    S=4096, int8 cache of the spec path's C = 4096 + 128 + 9) for one
    prefill forward, one decode step (eager, then the engine's step
    function replayed as a captured CUDA graph, from fill 4096, then the
    same captured step on the model's int8 copy, [int8] (f)) and one
    verify step (Sq=9 at fill 4160, through K3), and at path (c)'s (B=2, a
    bf16 prefill cache of 32768 slots, pads 0 and 12000, the decode cache
    at its 65th slot) for one long decode step, eager and captured: the
    first call's time on a fresh model and cache, the wall time after it
    (CUDA events), the device's busy time and kernel count
    (torch.profiler), the card's SM clock, power draw and clock-limit
    reasons (nvidia-smi) during a run, and the kernels that take most of
    the time. In one replay of each captured step the trace must show
    exactly one K2 (or K2p) kernel of each pass per layer, and the int8
    step's 113 GEMV kernels (4 a layer and the head), whose device time it
    logs (profile_call)."""
    from vnsum_tpu_torch.backend.capture import CapturedStep, decode_buffers, warm_up
    from vnsum_tpu_torch.backend.engine import TorchBackend
    from vnsum_tpu_torch.backend.long_context import long_decode_step, make_long_decode_attention
    from vnsum_tpu_torch.core.config import GenerationConfig
    from vnsum_tpu_torch.models.llama import (
        init_kv_cache,
        init_model,
        llama32_3b,
        prefill_positions,
        verify_positions,
    )
    from vnsum_tpu_torch.models.quant import quantize_model
    from vnsum_tpu_torch.ops.decode_attention import flash_decode_attention
    from vnsum_tpu_torch.ops.flash_attention import flash_prefill_attention
    from vnsum_tpu_torch.ops.verify_attention import flash_spec_verify_attention

    cfg = llama32_3b()
    dev = torch.device("cuda")
    G = cfg.q_per_kv
    B, S, fill = 8, 4096, 4096
    torch.cuda.empty_cache()  # start from an empty allocator, as the pipeline did
    model = init_model(cfg, 0, dev)
    # the spec path's cache (C = S + 128 + 9) serves all three map-batch steps
    cache = init_kv_cache(cfg, B, S + 128 + 9, quantized=True, device=dev)
    vfills = torch.full((B,), fill + 64, dtype=torch.int32, device=dev)
    pads = torch.zeros(B, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    tokens = torch.randint(0, 256, (B, S), generator=gen, device=dev)
    positions = prefill_positions(pads, S)

    def prefill():
        model(tokens, positions, cache, 0, None, last_only=True,
              stacked_attention_fn=lambda q, c, li: flash_prefill_attention(
                  q, c, li, pads, G, 0, 0))

    def decode():
        model(tokens[:, -1:], positions[:, -1:] + 1, cache, fill, None,
              stacked_attention_fn=lambda q, c, li: flash_decode_attention(
                  q, c, li, pads, fill, G, 0))

    def verify():
        model(tokens[:, -9:], verify_positions(pads, vfills, 9), cache, vfills, None,
              stacked_attention_fn=lambda q, c, li: flash_spec_verify_attention(
                  q, c, li, pads, vfills, G, 0))

    def capture(step, t0: int) -> CapturedStep:
        """The step warmed up at t0, then recorded (its buffers: ``out``
        holds 128 steps, the ~45 replays here fit)."""
        warm_up(lambda: step(t0), dev)
        return CapturedStep(lambda: step(t0 + 1))

    graphs = {}

    def captured_setup():
        engine = TorchBackend(model=model, batch_size=B, max_new_tokens=128, device="cuda")
        buffers = decode_buffers(
            tokens[:, -1].clone(), torch.zeros(B, dtype=torch.bool, device=dev), 128, 0)
        gen = GenerationConfig()
        graphs["decode"] = capture(engine._decode_step(
            buffers, cache, pads, S, S + 128 + 9, gen, 0, engine._sampling_setup(gen)), 0)

    def captured_decode():
        graphs["decode"].replay()

    def int8_setup():
        """[int8] (f): the same captured step on the model's int8 copy."""
        engine = TorchBackend(model=quantize_model(model), batch_size=B, max_new_tokens=128,
                              device="cuda")
        buffers = decode_buffers(
            tokens[:, -1].clone(), torch.zeros(B, dtype=torch.bool, device=dev), 128, 0)
        gen = GenerationConfig()
        graphs["int8"] = capture(engine._decode_step(
            buffers, cache, pads, S, S + 128 + 9, gen, 0, engine._sampling_setup(gen)), 0)

    def captured_int8_decode():
        graphs["int8"].replay()

    long = {}

    def long_setup():
        C = 32768
        long_pads = torch.tensor([0, 12000], dtype=torch.int32, device=dev)
        prefill_cache = long_cache(torch, cfg.n_layers, 2, cfg.n_kv_heads, C, cfg.head_dim,
                                   False, range(cfg.n_layers), 80, dev)
        long["attention"] = make_long_decode_attention(prefill_cache, long_pads, G)
        long["cache"] = init_kv_cache(cfg, 2, 128, device=dev)
        long["cur"] = tokens[:2, -1:]
        long["pos"] = (C - long_pads.long())[:, None] + 64
        buffers = decode_buffers(
            tokens[:2, -1].clone(), torch.zeros(2, dtype=torch.bool, device=dev), 128, 0)
        buffers["t"].fill_(64)
        graphs["long"] = capture(long_decode_step(
            model, long["attention"], buffers, init_kv_cache(cfg, 2, 128, device=dev),
            long_pads, C, torch.tensor([1], device=dev), 0,
            lambda rows, _: rows.argmax(dim=-1)), 64)

    def long_decode():
        model(long["cur"], long["pos"], long["cache"], 64, None,
              stacked_attention_fn=lambda q, c, li: long["attention"](q, c, li, 64))

    def captured_long_decode():
        graphs["long"].replay()

    with torch.inference_mode():
        for name, fn, n in (("prefill forward", prefill, 2), ("decode step", decode, 10),
                            ("captured decode step", captured_decode, 10),
                            ("captured int8 decode step", captured_int8_decode, 10),
                            ("verify step", verify, 10), ("long decode step", long_decode, 10),
                            ("captured long decode step", captured_long_decode, 10)):
            if fn is captured_decode:
                captured_setup()
            if fn is captured_int8_decode:
                int8_setup()
            if fn is long_decode:
                # the map batch's cache makes room for the long one
                graphs.clear()
                del cache
                torch.cuda.empty_cache()
                long_setup()
            profile_call(torch, name, fn, n, cfg.n_layers,
                         fn in (captured_decode, captured_int8_decode, captured_long_decode),
                         4 * cfg.n_layers + 1 if fn is captured_int8_decode else 0)
    del model, long, graphs
    torch.cuda.empty_cache()


def main() -> int:
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA card visible: chip_smoke.py runs on the card only", file=sys.stderr)
        return 2
    t_run = time.perf_counter()

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        now = time.perf_counter()
        log(f"[phase] {name}: {now - t0:.1f}s (run {now - t_run:.1f}s)")
        return out

    phase_environment(torch)
    timed("build", phase_build)
    errs = timed("correctness", phase_correctness, torch)
    phase_w8a8(torch)
    timed("planted faults", phase_mutants, len(CHECKED))
    timing = timed("timing", phase_timing, torch, errs)
    time_evaluation()
    launches, plain_summaries = timed("pipeline", phase_pipeline, torch)
    gemma_launches = timed("gemma3", phase_gemma, torch)
    phi4_launches = timed("phi4", phase_phi4, torch)
    qwen3_launches = timed("qwen3", phase_qwen3, torch)
    # the group-4 entries count the Phi-4 and Qwen3-8B phases
    group4_launches = {k: phi4_launches[k] + qwen3_launches[k] for k in COUNTERS}
    with registry_depth(llama_int8_cut, "llama3.2:3b"):
        int8_launches = timed("int8 pipeline", phase_int8_pipeline, torch, False)
        w8a8_launches = timed("w8a8 pipeline", phase_int8_pipeline, torch, True)
    weights_launches = timed("weights", phase_weights, torch, plain_summaries)
    timed("encoder", phase_encoder, torch)
    strategy_launches = timed("strategies", phase_strategies, torch)
    judge_launches = timed("judge", phase_judge, torch, plain_summaries)
    spec_launches, backend, prompts, oneshot = timed(
        "spec", phase_spec_pipeline, torch, plain_summaries)
    slot_launches = timed("slot", slot_loop, torch, backend.model, prompts, oneshot, "slot", 128)
    cache_launches, resume_launches = timed(
        "prefix cache", phase_prefix_cache, torch, backend.model, plain_summaries)
    serve_launches, serve_resume = timed("serve", phase_serve, torch, backend.model)
    resume_launches += serve_resume
    del backend
    long_launches = timed("long context", phase_long_context, torch)
    launches = {k: launches[k] + int8_launches[k] + w8a8_launches[k] + weights_launches[k]
                + strategy_launches[k] + judge_launches[k] + spec_launches[k] + slot_launches[k]
                + cache_launches[k] + serve_launches[k] + long_launches[k]
                for k in launches}
    timed("profile", phase_profile, torch)
    kernels = []
    for key, meta in KERNELS.items():
        # the head_dim-256 entries count the Gemma3 phase's launches, the
        # group-4 ones the Phi-4 and Qwen3-8B phases'
        if key.endswith("_hd256"):
            n = gemma_launches[key[:-6]]
        elif key.endswith(("_g4", "_phi4")):
            n = group4_launches[key.rsplit("_", 1)[0]]
        elif key == "prefill_resume":
            n = resume_launches
        else:
            n = launches[key]
        kernels.append({**meta, "launches": n, "max_abs_err": errs[key], **timing[key]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
