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
   and l each held to its own limit and o / l to K2's output, and at a
   seq = 2 shard of that cache (C = LONG_MESH_SHARD = 12,800, fill C - 1,
   phase 9h's KV 8 / H 24 bf16 and a model = 2 shard's KV 4 / H 12 bf16
   and int8, a shard's pads: both rows past them, none, a row whose pad
   covers the shard); K1, K2 and
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
   K1 and K2 at the fleet phase's batches (Llama's map batch and one map
   prompt a request at C = S + 64, int8); K1 and K2 on a tensor-parallel
   shard of the map batch (phase 9g: KV 4 and H 12 a rank at model = 2,
   KV 2 and H 6 at model = 4, int8, C = S + 128, and at model = 2 C = S +
   MESH_TP_NEW, fills S and C - 1), timed on their own (a ``[phase3]``
   line); K1 and K3 at the spec calls of CHECKS_SPEC_NEW new tokens (C = S
   + 32 + 9, int8);
   the fixture phase's shape (FIXTURE_KV = 1, FIXTURE_G = 2, head_dim 128):
   K1 and K2 at its map and reduce batches (FIXTURE_SHAPES, C = S + 128),
   bf16 and int8, K3 at its spec step (Sq = 9: 18 rows, C = S + 137) and
   slot segment (Sq = 1: 2 rows, C = 2048) with K1 over the spec caches, K1
   at the slot loop's join groups (B = 1, 2, 4) and at the warm resume
   (Sq = 128 at q_offset 1792), bf16 and int8, and at one row of the
   margin rule's recompute (B = 1, S = C = 1280-1664, int8);
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
   5120 + 1280 + 1280, gate/up 17920 + 17920) at the same four row counts,
   and at the fixture's (FIXTURE_GEMV_SHAPES, FIXTURE_GEMV_GROUPS: K = 256
   and 512, the cluster split of w_down's 512 leaving 256 a block);
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
   fail their cases as well. The copies are made and their builds started
   right after phase 2, so they compile while phase 3 runs; they run four
   at a time, each as soon as its build is done and a place is free; each
   copy's build and run seconds and its model-shard cases' seconds are
   logged;
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
   at the long path's shape (B=2, C=32768, bf16 and int8) and at phase
   9h's seq = 2 shard (B=2, C=12800, bf16), whose library
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
   on the card, the model cut to INT8_LAYERS = 4 of its 28 layers: K1 = 4 x
   prefill forwards, K2 = 4 x decode steps and GEMV launches = 17 x decode
   steps (q/k/v, wo, gate/up and w_down a layer, and the head) + one per
   prefill forward (its head; and 16 more where B x S <= 128 without
   W8A8) exactly, K2p = K3 = 0, and
   summaries byte-identical to an eager run;
6a. gemma3: the CLI's map-reduce over data/vi_eval with --models gemma3-4b
   (Gemma3-4B at its published width, cut to GEMMA_LAYERS = 8 of its 34
   layers (its global at 5) to keep the run under 600 s: dim 2560,
   8/4 heads, head_dim 256, vocab 262,208, tied head, a 1024-slot window on
   the layers where (i + 1) % 6 != 0; random bf16 weights from seed 0, byte
   tokenizer, int8 KV cache, greedy), decode steps captured: every document
   ok, ROUGE and the embedding metrics computed, K1 = 8 x prefill
   forwards and K2 = 8 x decode steps exactly, K2p = K3 = GEMV = 0, every
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
   exactly 8 x the engine record's prefill forwards, decode steps and
   verify steps; wall, prefill and decode seconds and steps, peak memory
   on ``[gemma3]`` lines, the paths on ``[gemma3 spec]`` and ``[gemma3
   slot]`` lines;
6b. phi4: Phi-4-14B at its published width (dim 5120, 40/10 heads: GQA
   group 4, head_dim 128, intermediate 17,920, vocab 100,352, untied head),
   cut to PHI4_LAYERS = 4 of its 40 layers (registry_depth); random bf16
   weights from seed 0, byte tokenizer, FAMILY_NEW = 64 new tokens: the
   CLI's map-reduce with --models phi4:14b, decode steps captured, and an
   eager control byte-identical to it, K1 = 4 x prefill forwards and K2 =
   4 x decode steps exactly, K2p
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
6c. qwen3: Qwen3-8B at its published width (dim 4096, 32/8 heads: GQA
   group 4, head_dim 128, QK norm, intermediate 12,288, vocab 151,936),
   cut to QWEN3_LAYERS = 6 of its 36 layers (registry_depth); random bf16
   weights, FAMILY_NEW new tokens): the CLI's map-reduce captured, K1 = 6
   x prefill forwards and K2 = 6 x decode steps exactly, every batch one
   phase 3 checked, and the dense logits gate;
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
   (chunk_size 1024, 128 new tokens; critique at CRITIQUE_TOKEN_MAX = 4,
   which must take at least one collapse round and the token_max // 2
   context pass) on Llama-3.2-3B at full width (critique, iterative and
   skeleton at STRATEGY_CUT_LAYERS = 4 of 28 layers, hierarchical at 2,
   HIERARCHICAL_LAYERS; random bf16 weights from seed 0), batch 8, int8
   KV cache, decode steps captured: every document ok,
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
   second random 3B model at full width and JUDGE_CLI_LAYERS = 4 of its 28
   layers, free decode of up to 256 new tokens, captured): 7 cases
   processed, K1 and K2 launches exactly each engine's depth x its prefill
   forwards and decode steps, summaries the pipeline phase's.
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
   TorchBackend on the same model at 64 new tokens (SERVE_NEW), in six
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
   /healthz, /readyz and /metrics in their schemas; (e) durable serving
   (serve/journal.py, ROADMAP A15b-1): a journaled server answers the 7
   prompts and GET /v1/requests/<id> gives back each text byte for byte;
   a journal holding the 7 ACCEPTs and no terminal record (a life that
   died before dispatch) is replayed by a fresh ServeState: /readyz
   pre_replay before, replay_journal() 7 then 0, every entry complete
   with the direct generate's text byte for byte, journal_replayed_total
   7, K1/K2 exact, K3 = 0; a copy replays through the in-flight scheduler
   (K1/K3 exact, K2 = 0, agreement logged); (f) the strategies' streaming
   rounds: POST /v1/summarize (mapreduce, served at chunk size 1024,
   SERVE_CHUNK, through ServeState(pipeline_overrides=...)) of a 4-chunk
   data/vi_eval document, the reduce
   submitted from harvest (QueuedBackend's calls recorded: the map round,
   its harvests, the reduce; no barrier generate), the poll surface's
   gang phases map and reduce, the summary byte-identical to
   summarize_batch on a plain TorchBackend, K1/K2 exact; then two
   documents as two concurrent requests (both 200, K1/K2 exact, agreement
   logged); (g) tenants and SLOs (serve/qos.py, serve/slo.py, ROADMAP
   A15b-2; QOS_TENANTS ui:4:0 and bulk:1:0:batch): (g1) on the micro-batch
   scheduler a primer of its own batch key, then 8 bulk and 4 ui requests
   queued in its window, in that order: the engine's batch of 8 is
   exactly what TenantTable.select picks from the 12 (reckoned on the host
   with the port's own table: the 4 ui rows first), the tail the other 4
   bulk rows, every text byte-identical to the direct generate of its
   batch, K1/K2 exact; (g3) on the same server, host-only: a metered
   tenant's drained bucket sheds 429 quota with retry_after_s inside the
   refill arithmetic and an integral Retry-After, an unknown X-Tenant a
   typed 400, --slo e2e_p99=600,ttft_p99=0.001 shows e2e_p99 compliant
   and ttft_p99 breaching on both windows, one slo_breach in the flight
   recorder and its dump on disk, the /healthz SLO line and the
   vnsum_serve_slo_* gauges; (g2) in flight (8 slots, 64 new tokens in
   8-step segments, the 512-block prefix cache, --preempt-budget 4, a
   journal): 8 tagged bulk requests fill the slots, then 2 ui requests
   evict exactly 2 of them at the next segment boundary (pinned,
   qos_preemptions_total and qos_requeues_total 2, PREEMPTED and REQUEUED
   journal records for exactly those two), both re-join warm at K = 3584
   (K1 at that q_offset), the ui rows' first tokens before the last bulk
   reply, every request 200, K1/K3 exact against the loops' record; the
   evictees against a one-shot run logged. Each server's close() drains
   within its budget and leaves no scheduler or watchdog thread; ``[serve]`` lines give each arm's wall,
   TTFT and end-to-end p50/p99 from the server's own histograms,
   requests/s, segments and peak memory, and for (e) and (f) the replay
   seconds, journal records, bytes and fsyncs;
9d. fixture (ROADMAP A2b): the committed trained fixture
   data/fixtures/llama_k128 (scripts/make_torch_fixture.py: 2 layers,
   hidden 256, 2 query heads on 1 KV head at head_dim 128, bf16, trained on
   data/vi_eval) with its own byte-level BPE tokenizer, read by text/bpe.py
   with no transformers, at 128 new tokens, every batch one of phase 3's
   FIXTURE_SHAPES: (a) the CLI's map-reduce with --weights-dir, int8 cache,
   decode captured, K1 and K2 exactly 2 x the record's forwards and steps,
   ROUGE-1/2/L, the rows that stop at EOS and the mean output tokens
   logged; (b) the arms of scripts/make_quality_lossy_ab.py on the map
   prompts (the f32 dense oracle, no kernel launched; bf16 through the
   kernels over a bf16 cache; the int8 cache; --quantize, the GEMV at K =
   256 and 512; W8A8), each arm's launches exact and its string agreement
   and ROUGE-L against the oracle logged; (c) the spec path through
   PipelineRunner (spec_k 8, K3 at 18 rows) and, on its backend, the map
   prompts with their chunks and the oracle as references, drafts and
   acceptances logged, the oracle accepting; (d) the slot loop (S = 1920,
   fused 4); (e) the map prompts cold then warm through a 256-block prefix
   cache, the warm call resuming at K = 1792 (K1 at q_offset 1792); (f)
   tier preemption: InflightScheduler with QOS_TENANTS over a 256-block
   cache, 8 tagged batch-tier rows (the map prompts and the first again)
   fill the 8 slots, two interactive rows evict some at the next boundary,
   and every evictee re-joins warm at K = 1792, its text held to the
   one-shot run of the same prompts under the margin rule. Every arm's
   launches exact. The margin rule (FIXTURE_MARGIN_RTOL): every row
   whose ids differ from its reference arm's (the oracle for (b), the
   int8-cache arm's one-shot run for (c) and (d), the cold call for (e))
   logs its first differing step and the reference's top-1 - top-2 logit
   margin there over its largest |logit| (for (f) the int8-cache arm's
   one-shot run of its tagged prompts), and one above the path's limit
   fails the run; agreement rates are logged, not gated;
9e. fleet (ROADMAP A15b-3): the port's router in front of worker
   processes of the port's server, every process the phase starts
   stopped and gated gone at its end, no kernel library built or
   rewritten by a worker. Fleet A: ``python -m
   vnsum_tpu_torch.serve.router --spawn-workers 2 --backend torch`` (run
   through testing/chaos.py's RouterProcess) over two Llama-3.2-3B
   workers at full width and depth from seed 0, int8 cache, no prefix
   cache, 64 new tokens; their memory on the card (nvidia-smi's compute
   apps and the card's free memory) at least their weights each; (h1) the
   7 map prompts as one request, byte-identical to phase 9c's direct
   generate, then 8 single requests pinned by cache_hint, each on the
   worker the crc32 rendezvous ranking names (the router's flight
   recorder), 4 on each, and a stream answered a typed 501; (h4) the
   router's vnsum_serve_fleet_requests_total equal to the sum of the
   workers' requests_total, /debug/trace stitching the batch's router
   and worker spans in one process, and SIGUSR1 writing one incident
   bundle with both workers' rings, folded in wall order; SIGTERM: router
   rc 0, its journal sealed. Fleet B: a RouterState in this process over
   two build_fleet handles of the trained fixture, in flight (8 slots, S
   = 1920, 128 new tokens, no prefix cache): (h2) 7 requests pinned to
   worker-0, which is SIGKILLed once its journal holds their ACCEPTs:
   every client answered 200, byte-identical to an uninterrupted run of
   the same 7, the router journal completing each, failovers counted,
   worker-0 respawned and back in rotation; (h3) POST
   /admin/rolling-restart answered 202 under a request every 100 ms, every
   one answered 200, each worker drained (rc 0, journal sealed), restarted
   one generation on and back in rotation, its seconds out of rotation
   logged. The workers' launches are counted in their own processes;
9f. checks (ROADMAP A14): (a) on the spec phase's Llama-3.2-3B under
   VNSUM_SANITIZERS=transfer (CUDA's sync debug mode at "error" inside the
   engine's dispatch loops): generate on the 7 map prompts (captured
   decode), the spec path at CHECKS_SPEC_NEW new tokens with the one-shot
   outputs as references, one slot-loop admit and step, score_choices on
   two prompts, each byte-identical to the same call without the guard,
   the guard armed and the mode back at 0 after each, launches exact; a
   planted .item() inside the guard must raise and pass inside an
   acknowledged section; (b) the trained fixture behind the port's
   supervised schedulers with each VNSUM_FAULTS plan of CHECKS_PLANS
   armed (engine.dispatch raise, engine.slot_step resource, an
   engine.dispatch poison matching one prompt, engine.slot_admit raise):
   exactly the firings, failure classes and rung the JAX engine gives in
   the same scenario, the poisoned request failed POISON and quarantined
   alone, every other answer byte-identical to the unfaulted run's; (c)
   ``python -m vnsum_tpu_torch.analysis vnsum_tpu_torch`` as a subprocess
   exits 0 with no finding; (d) the pipeline phase's results.tracing holds
   the runner's spans (RUNNER_SPANS, names and counts; every CLI run's
   results are held to them), and phase 11 holds the engine's annotate
   ranges and the captured step's wall;
9g. mesh (ROADMAP A10a): (a) init_distributed forms a world-1 NCCL group
   from MASTER_ADDR / MASTER_PORT (an all-reduce checked); on the spec
   phase's Llama-3.2-3B, TorchBackend(mesh=make_mesh({})) (the 1x1 shard
   shares the model's tensors) runs the map batch (B=8, S=4096, 128 new
   tokens, captured steps) byte-identical (texts and id rows) to the spec
   phase's unmeshed one-shot run, then the spec path (spec_k 8,
   MESH_SPEC_NEW new tokens, the chunks as references) byte-identical to
   the unmeshed engine's; K1, K2 and K3 launches exact, and the mesh
   wrappers' calls (ops/sharded.py) equal to K1's and K2's. (c) two ranks
   spawned on the one card at the phase's start (they start up while (a)
   runs) form a gloo group; a probe all-reduces a bf16
   CUDA tensor; init_distributed accepts the group; each runs a model = 2
   mesh's engine (Llama-3.2-3B at full width and MESH_TP_LAYERS = 4 of
   its 28 layers from seed 0, sharded by the engine, int8 cache, eager)
   on the map batch at MESH_TP_NEW new tokens, while this process runs the
   unsharded engine on the same weights: each rank's K1 and K2 launches
   and wrapper calls exact, the two ranks' logits and texts equal, the
   prefill's and the first MESH_GATE_STEPS decode steps' logits within
   MESH_TP_RTOL of the unsharded engine's and a fault planted in rank 1's
   own process (its all-reduce of layer 1's w_down partial left out) past
   it; greedy agreement logged, not gated; the ranks then build phase 9i
   (c)'s trainers while 9h runs and train at 9i's "go";
9h. long mesh (ROADMAP A10b): the pipeline CLI's whole-document launch,
   ``--approach truncated --long-context --mesh seq=2 --max-context
   24576 --max-new-tokens 32 --batch-size 2 --device cuda``, in two
   ranks on the one card (spawned at 9f's start, waiting for 9h's go),
   each forming a gloo group first, as torchrun's processes would on two
   cards; path (c)'s two documents, Llama-3.2-3B at full width and
   LONG_MESH_LAYERS = 4 of its 28 layers (registry_depth in each rank):
   a 25,600-slot bucket, 12,800 slots a rank, the ring prefill (plain
   torch) and K2p over each shard merged across seq. Gates: (i)
   init_distributed accepts the group, the mesh reads {data 1, model 1,
   seq 2}; (ii) the prefill's and the first 4 decode steps' logits within
   LONG_MESH_RTOL (0.1, 9g (c)'s measure) of a one-rank backend's on the
   same weights and prompts, the two ranks' bits equal; (iii) a planted
   fault (rank 1 keeps its own K2p partial of o on every layer) past it;
   (iv) rank 0 wrote both summaries, one results JSON (ROUGE, the
   embedding metrics, the runner's spans) and one log, rank 1 nothing (an
   audit hook); (v) each rank's K2p launches exactly 4 x its decode steps
   (256 over both at 32 steps), no other kernel. Greedy agreement, each
   rank's prefill and decode seconds and peak memory logged;
9i. train (ROADMAP A12a, A12b): the probe of whether ``aten::mm.dtype`` has a
   derivative (logged); (a) one card, Llama-3.2-3B at full width and
   TRAIN_LAYERS = 4 of its 28 layers, bf16, a Trainer over a one-rank mesh
   with remat, a B=2 S=1024 batch from a seeded generator: (i)
   forward_train's logits within TRAIN_LOGITS_RTOL (0.1 of the largest
   logit) of the cached forward's through K1 on the same tokens; (ii)
   every leaf's bf16 gradient within TRAIN_GRAD_RTOL (relative L2) of an
   f32 copy's, the worst leaf logged; (iii) TRAIN_STEPS = 8 steps at lr
   1e-4, finite, the last loss below the first; (iv) a TrainCheckpointer
   save after step 2, restored into a trainer of another seed: every
   parameter and moment bit-equal, its next loss the saved trainer's bit
   for bit; the steps launch no kernel (every counter exactly 0). (c) the
   model = 2 step of phase 9g (c)'s two ranks on the same weights and
   batch: the gathered gradients of wq, w_down, embed and attn_norm and
   the loss within TRAIN_GRAD_RTOL of (a)'s one-rank ones, the two ranks'
   losses equal, no kernel launched (the ranks train while (a) runs
   here), and a fault planted in rank 1 (its
   f, ``copy_to_group``, skips its backward all-reduce) past the limit on
   wq and attn_norm. (b), not gated: the full 28 layers, 3 steps at B=2
   S=2048, step seconds, tokens/s and peak memory logged, while 9g (c)'s
   two ranks go on to (d) {fsdp: 2}, TrainConfig(fsdp=True), and (e)
   {seq: 2}, TrainConfig(context_parallel=True), each a second mesh over
   the same gloo group, one step each on (a)'s weights and batch (512
   positions a rank under (e)): the gathered gradients of wq, w_down,
   embed and attn_norm within TRAIN_GRAD_RTOL of (a)'s, the loss within
   1e-3, the two ranks' losses equal, no kernel launched; under (d) each
   rank holds half of (a)'s bytes of layer parameters and of moments; the
   planted faults ((d) rank 1's gather_layer keeps its own share of its
   layers' gradient, (e) the backward ring leaves dk/dv one shift short of
   home) past the limit on wq and attn_norm, and on wq;
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
   must equal the captured bf16 run's byte for byte; then, gated, the
   long path's logits (the prefill's last position and the first decode
   steps) against the one-card engine's (max_seq_len 40960, the same
   weights) on the same tokens, at the
   path's shape and a short one, each within its LONG_LOGITS_RTOL, with two
   faults planted in the script's own calls that must exceed it at both;
11. profile: one prefill forward, one decode step (eager and captured) and
   one verify step (Sq=9) at the map batch's shape and one long decode step
   (eager and captured) at path (c)'s, with their wall time, the device's
   busy time (torch.profiler), the card's clock and power draw while they
   run, and the kernels that take most of the time; one replay of each
   captured step must show 28 K2 (K2p) kernels of each pass in the trace;
   [int8] (f): the captured decode step on the same model's int8 copy, its
   113 GEMV kernels and their device time; 9f (d): the captured decode
   step's wall against its earlier runs' (CAPTURED_STEP_MS, failed past
   CAPTURED_STEP_MARGIN times their top), and one engine generate on the
   map batch under torch.profiler whose trace holds the host ranges
   generate[B=8,S=4096], prefill[B=8,S=4096] and decode_seg[B=8,S=4096]
   once each.

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
resume shape, K1 and K2 on a model = 2 shard, K2p on a seq = 2 shard, and
the GEMV at Phi-4's widths, entries of their own), whose
``launches`` sums the path phases (the head_dim-256 entries: the Gemma3
phase's; the group-4 and Phi-4 ones: the Phi-4 and Qwen3-8B phases'; the
resume entry: K1's launches in the resumed prefill forwards of phases
9b and 9c; the model = 2 shard ones: phase 9g (c)'s two ranks', read
from their processes; the seq = 2 shard one: phase 9h's two ranks'; K1, K2, K3 and the GEMV entries also count phase
9d's at the fixture's shape and phase 9g (a)'s); the last line
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
# the fixture phase (9d, trained weights): the margin rule. A row whose
# greedy ids differ from its reference arm's logs its first differing step
# t and the reference's top-1 - top-2 logit margin at t over its largest
# |logit|, recomputed through the reference arm's own prefill (K1 over its
# cache type, or its dense forward) over the prompt and the reference's
# first t tokens. Where the arm and its reference run the same weights and
# cache type and differ by summation order and tiling alone, the limit is
# the gate that bounds those differences, the most they were shown to move
# a logit (relative to the largest): a token whose margin is larger cannot
# flip by rounding, so a first difference above it is a fault. The spec
# path against the one-shot run: the spec gate's; the slot loop: the
# one-step K3/K2 gate's; a warm resume against the cold call: the resume
# gate's (RESUME_LOGITS_RTOL, 0.1); a preemption evictee (a slot-loop
# decode whose second life resumes warm) against the one-shot run: the
# larger of the slot loop's and the resume's. The lossy arms against the f32 dense
# oracle change the arithmetic itself (bf16 weights' products, the int8
# cache's 1/254 steps, int8 weights, W8A8), which no gate bounds: on this
# trained model the int8 cache flips a token at a margin of 0.19, through
# the kernels on the card as through their plain versions on the CPU.
# Their margins are logged, not gated (None)
FIXTURE_MARGIN_RTOL = {"lossy": None, "spec": SPEC_LOGITS_RTOL, "slot": STEP_KERNEL_RTOL,
                       "resume": 0.1, "preempt": max(STEP_KERNEL_RTOL, 0.1)}
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
    # K1 and K2 on a tensor-parallel shard (model = 2: 12 query heads on 4
    # KV heads a rank), the same kernels at other shapes: times at the map
    # batch (C=4224), launches those of phase 9g (c)'s two ranks (C=4112)
    "prefill_tp": {
        "name": "flash_prefill_attention (model=2 shard)",
        "route": "cuda",
        "source": "vnsum_tpu_torch/ops/csrc/flash_prefill.cu",
        "replaces": "vnsum_tpu/ops/flash_attention.py:313",
    },
    "decode_tp": {
        "name": "flash_decode_attention (model=2 shard)",
        "route": "cuda",
        "source": "vnsum_tpu_torch/ops/csrc/flash_decode.cu",
        "replaces": "vnsum_tpu/ops/decode_attention.py:381",
    },
    # K2p on a seq = 2 shard of the long path's prefill cache (C = 12,800
    # slots of a 25,600-slot bucket): times at that shape, launches those
    # of phase 9h's two ranks
    "partials_shard": {
        "name": "flash_decode_partials (seq=2 shard)",
        "route": "cuda",
        "source": "vnsum_tpu_torch/ops/csrc/flash_decode.cu",
        "replaces": "vnsum_tpu/ops/decode_attention.py:381",
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


def compare_partials(torch, case, got, want, k2_out, vmax, worst, key="partials") -> None:
    """Holds K2p's (o, m, l) against its plain version's, each at its own
    limit, and o / max(l, 1e-30) against K2's output on the same cache at
    K2's limit; logs one line for the case with the largest err/limit of
    the four (kept in ``worst[key]``). ``vmax`` is the largest |v| of the
    layer."""
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
    worst[key] = max(worst[key], float(parts["o"][0].max()), float(parts["m"][0].max()),
                     float(parts["l"][0].max()))
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
# tier preemption (phase 9c arm g2, phase 9d's preemption arm): evictees
# re-join one or two at a boundary, resuming warm at the map batch's K
QOS_REJOIN_BATCHES = (1, 2)
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
             "prefill_g4": 0.0, "decode_g4": 0.0, "verify_g4": 0.0, "gemv_phi4": 0.0,
             "prefill_tp": 0.0, "decode_tp": 0.0, "partials_shard": 0.0}

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
    # a tensor-parallel shard's map batch (phase 9g): Llama-3.2-3B over a
    # model axis of m ranks holds KV / m KV heads and H / m query heads a
    # rank (12/4 at m = 2, 6/2 at m = 4), the pipeline's pads and its
    # all-pad filler row, int8 (the path's cache) at C = S + 128 and, at
    # m = 2, at 9g (c)'s C = S + MESH_TP_NEW; decode at the first and the
    # last step. Timed on their own: each planted-fault copy runs them too
    t_shard = time.perf_counter()
    S, pads_h = 4096, [0, 37, 400, 1000, 2500, 3000, 4095, 4096]
    for m, C in ((2, S + 128), (2, S + MESH_TP_NEW), (4, S + 128)):
        kv = KV // m
        cache = make_cache(torch, 2, 8, kv, C, hd, True, 170 + m + C, dev)
        prefill(f"int8=True B=8 S={S} C={C} KV={kv} H={kv * G} layer=1 (model={m} shard)",
                rand_q(torch, (8, S, kv * G, hd), 171 + m, dev), cache, 1, pads_of(pads_h), 0,
                0, empty_row=7, key="prefill_tp")
        for fill in (S, C - 1):
            decode(f"int8=True B=8 C={C} KV={kv} fill={fill} layer=1 (model={m} shard)",
                   rand_q(torch, (8, 1, kv * G, hd), 172 + fill + m, dev), cache, 1,
                   pads_of(pads_h), fill, 0, key="decode_tp")
        del cache
    log(f"[phase3] model-shard cases: {time.perf_counter() - t_shard:.2f}s")
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
    # the serve phase's tier preemption (arm g2, C = S + QOS_NEW): an
    # evictee's warm re-join prefills one or two rows at the warm K, int8,
    # rows starting before K
    K, Cq = RESUME_OFFSETS[-1], S + QOS_NEW
    for B in QOS_REJOIN_BATCHES:
        cache = make_cache(torch, 2, B, KV, Cq, hd, True, 155 + B, dev)
        prefill(f"int8=True B={B} S={S} C={Cq} q_offset={K} layer=1 (tier preemption's warm "
                "re-join)", rand_q(torch, (B, S - K, H, hd), 156 + B, dev), cache, 1,
                pads_of([37, K - 300][:B]), 0, K, key="prefill_resume")
        del cache
    # the fleet phase's batches (9e, fleet A; 9c's arms (a), (d) and (e)
    # too): the map batch and one map prompt a request at S = 4096,
    # C = S + SERVE_NEW, the workers' int8 cache
    Cf = S + SERVE_NEW
    for pads_h, what in (([0, 37, 400, 1000, 2500, 3000, 4095, 4096], "map batch"),
                         ([1246], "single request")):
        B = len(pads_h)
        cache = make_cache(torch, 2, B, KV, Cf, hd, True, 157 + B, dev)
        prefill(f"int8=True B={B} S={S} C={Cf} layer=1 (fleet {what})",
                rand_q(torch, (B, S, H, hd), 158 + B, dev), cache, 1, pads_of(pads_h), 0, 0,
                empty_row=B - 1 if B > 1 else None)
        for fill in (S, Cf - 1):
            decode(f"int8=True B={B} C={Cf} fill={fill} layer=1 (fleet {what})",
                   rand_q(torch, (B, 1, H, hd), 159 + B + fill, dev), cache, 1,
                   pads_of(pads_h), fill, 0)
        del cache
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
    # the spec calls at CHECKS_SPEC_NEW (= MESH_SPEC_NEW) new tokens (phases
    # 9f (a) and 9g (a)): C = S + 32 + 9, int8, K1 over the cache (its
    # scale rows no multiple of 16 bytes apart) and K3 with the same kinds
    # of rows at fills S + e, e <= 32
    C = S + CHECKS_SPEC_NEW + Sq
    cache = make_cache(torch, 3, 8, KV, C, hd, True, 43, dev)
    prefill(f"int8=True B=8 S={S} C={C} layer=2 (spec path, {CHECKS_SPEC_NEW} new tokens)",
            rand_q(torch, (8, S, H, hd), 44, dev), cache, 2,
            pads_of([0, 37, 400, 1000, 2500, 3000, 4095, 4096]), 0, 0, empty_row=7)
    verify(f"int8=True B=8 Sq={Sq} C={C} window=0 layer=2 (spec path, {CHECKS_SPEC_NEW} new "
           "tokens)", rand_q(torch, (8, Sq, H, hd), 45, dev), cache, 2,
           [0, 37, 400, 1000, 2500, 4113, 4095, 4096],
           [4088, 4090, 4100, 4127, 4096 + CHECKS_SPEC_NEW, 4110, 4096, 4111], 0,
           blind=((5, slice(0, 3)),))
    del cache
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

    # the fixture phase (9d): the trained fixture's shape, GQA group 2 on
    # one KV head at head_dim 128, at every batch its paths send. K1 and K2
    # at the map and reduce batches (FIXTURE_SHAPES, C = S + 128), bf16 (a
    # lossy arm's cache) and int8, decode at the first and the last step;
    # K3 at fixture_verify_cases (the spec step's 18 rows, the slot
    # segment's 2), bf16 and int8 at the map batch, with K1 over the spec
    # path's int8 caches (C = S + 137); K1 at the slot loop's join groups
    # and at the warm resume (Sq = 128 at q_offset FIXTURE_RESUME_K)
    FH = FIXTURE_KV * FIXTURE_G
    for S, pads_h in FIXTURE_SHAPES.items():
        B, C = len(pads_h), S + FIXTURE_NEW
        for quantized in (True, False):
            cache = make_cache(torch, 2, B, FIXTURE_KV, C, hd, quantized, 170 + S + quantized, dev)
            prefill(f"fixture int8={quantized} B={B} S={S} C={C} layer=1 (fixture batch)",
                    rand_q(torch, (B, S, FH, hd), 171 + S, dev), cache, 1, pads_of(pads_h), 0,
                    0, empty_row=B - 1, g=FIXTURE_G)
            for fill in (S, C - 1):
                decode(f"fixture int8={quantized} B={B} C={C} fill={fill} layer=1 (fixture "
                       "batch)", rand_q(torch, (B, 1, FH, hd), 172 + fill, dev), cache, 1,
                       pads_of(pads_h), fill, 0, g=FIXTURE_G)
            del cache
    for what, S, Sq, C, fills_h, pads_h in fixture_verify_cases():
        B = len(fills_h)
        for quantized in (True, False) if S == max(FIXTURE_SHAPES) else (True,):
            cache = make_cache(torch, 2, B, FIXTURE_KV, C, hd, quantized, 180 + C + quantized,
                               dev)
            if quantized and Sq > 1:
                prefill(f"fixture int8=True B={B} S={S} C={C} layer=1 (fixture {what})",
                        rand_q(torch, (B, S, FH, hd), 181 + S, dev), cache, 1,
                        pads_of(FIXTURE_SHAPES[S]), 0, 0, empty_row=B - 1, g=FIXTURE_G)
            verify(f"fixture int8={quantized} B={B} Sq={Sq} C={C} layer=1 (fixture {what})",
                   rand_q(torch, (B, Sq, FH, hd), 182 + C, dev), cache, 1, pads_h, fills_h,
                   blind=((5, slice(0, 3)),) if Sq > 1 else (), g=FIXTURE_G)
            del cache
    S = max(FIXTURE_SHAPES)
    C, K = S + FIXTURE_NEW, FIXTURE_RESUME_K
    for B in FIXTURE_JOIN_BATCHES:
        cache = make_cache(torch, 2, B, FIXTURE_KV, C, hd, True, 190 + B, dev)
        prefill(f"fixture int8=True B={B} S={S} C={C} layer=1 (fixture slot join group)",
                rand_q(torch, (B, S, FH, hd), 191 + B, dev), cache, 1,
                pads_of([450 + 37 * r for r in range(B)]), 0, 0, g=FIXTURE_G)
        del cache
    for quantized in (True, False):
        cache = make_cache(torch, 2, 8, FIXTURE_KV, C, hd, quantized, 195 + quantized, dev)
        prefill(f"fixture int8={quantized} B=8 S={S} C={C} q_offset={K} layer=1 (fixture "
                "prefix-cache resume)", rand_q(torch, (8, S - K, FH, hd), 196, dev), cache, 1,
                pads_of([0, 37, K - 300, K - 1, K + 1, K + 60, S - 1, S]), 0, K, empty_row=7,
                g=FIXTURE_G)
        del cache
    for B in QOS_REJOIN_BATCHES:
        cache = make_cache(torch, 2, B, FIXTURE_KV, C, hd, True, 192 + B, dev)
        prefill(f"fixture int8=True B={B} S={S} C={C} q_offset={K} layer=1 (fixture tier "
                "preemption's warm re-join)", rand_q(torch, (B, S - K, FH, hd), 193 + B, dev),
                cache, 1, pads_of([450, 726][:B]), 0, K, g=FIXTURE_G)
        del cache
    # the margin rule's recompute: one row, left-padded to a multiple of 128
    # slots, C = S, through the one-shot run's int8 cache
    for S in FIXTURE_MARGIN_S:
        cache = make_cache(torch, 2, 1, FIXTURE_KV, S, hd, True, 197 + S, dev)
        prefill(f"fixture int8=True B=1 S=C={S} layer=1 (fixture margin rule)",
                rand_q(torch, (1, S, FH, hd), 198 + S, dev), cache, 1, pads_of([100]), 0, 0,
                g=FIXTURE_G)
        del cache
    torch.cuda.empty_cache()

    partials_cases(torch, worst)
    shard_partials_cases(torch, worst)
    gemv_cases(torch, worst)
    gemv_cases(torch, worst, PHI4_GEMV_SHAPES, PHI4_GEMV_GROUPS, "gemv_phi4", seed=500)
    gemv_cases(torch, worst, FIXTURE_GEMV_SHAPES, FIXTURE_GEMV_GROUPS, seed=700)
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


def shard_partials_cases(torch, worst, dev="cuda") -> None:
    """K2p at a shard of the long path's prefill cache, C = LONG_MESH_SHARD
    slots (a 25,600-slot bucket over two seq ranks): phase 9h's (KV 8, H
    24, bf16) and a model = 2 shard's (KV 4, H 12, bf16 and int8), fill
    C - 1, LONG_MESH_LAYERS layers (0 and the last drawn); the pads as a
    seq rank sees them: rank 0 both rows past their pads (9h's two
    prompts'), rank 1 none, and a row whose pad covers the shard (exactly
    inert)."""
    L, B, G, hd, C = LONG_MESH_LAYERS, 2, 3, 128, LONG_MESH_SHARD
    for KV, quantized in ((8, False), (4, False), (4, True)):
        cache = long_cache(torch, L, B, KV, C, hd, quantized, (0, L - 1), 80 + KV + quantized,
                           dev)
        for layer, pads_h in ((0, [800, 5300]), (L - 1, [0, 0]), (L - 1, [C, 4000])):
            q = rand_q(torch, (B, 1, KV * G, hd), 81 + layer + pads_h[1] + KV, dev)
            pads = torch.tensor(pads_h, dtype=torch.int32, device=dev)
            check_partials(
                torch, worst, f"partials int8={quantized} B={B} KV={KV} H={KV * G} C={C} "
                f"fill={C - 1} pads={pads_h} layer={layer} (a seq = 2 shard"
                + (", model = 2)" if KV == 4 else ", phase 9h)"), q, cache, layer, pads,
                C - 1, G, inert_rows=[row for row, pad in enumerate(pads_h) if pad >= C],
                key="partials_shard")
        del cache
    torch.cuda.empty_cache()


def check_partials(torch, worst, case, q, cache, layer, pads, fill, G, inert_rows=(),
                   key="partials") -> None:
    """K2p against its plain version, and o / l against K2, on one input
    (``compare_partials``, ``worst[key]``); each of ``inert_rows`` sees no
    key and must come out exactly m = -1e30, l = 0, o = 0."""
    from vnsum_tpu_torch.ops import decode_attention as da

    got = da.flash_decode_partials(q, cache, layer, pads, fill, G)
    want = da.flash_decode_partials_ref(q, cache, layer, pads, fill, G)
    k2 = da.flash_decode_attention(q, cache, layer, pads, fill, G)
    compare_partials(torch, case, got, want, k2, float(cache_v_amax(cache, layer)), worst, key)
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


def start_mutant_builds() -> dict:
    """Phase 4's first half, started right after phase 2 so that its
    compiles (nvcc alone, no card) run while phase 3 holds the card: one
    temporary copy of the package per planted fault of MUTANTS, its fault
    planted, each copy's build started at once. Each copy starts from the
    kernels phase 2 built, so it compiles only the source its fault is
    planted in. Returns the copies and their builds for phase_mutants."""
    root = Path(tempfile.mkdtemp(prefix="vnsum_mutants_"))
    copies = []
    for i, (what, kernel, source, text, replacement) in enumerate(MUTANTS):
        tmp = root / str(i)
        shutil.copytree(ROOT / "vnsum_tpu_torch", tmp / "vnsum_tpu_torch",
                        ignore=shutil.ignore_patterns("*.tmp", "__pycache__"))
        shutil.copy(ROOT / "chip_smoke.py", tmp)
        cu = tmp / "vnsum_tpu_torch" / "ops" / "csrc" / source
        code = cu.read_text()
        if code.count(text) != 1:
            shutil.rmtree(root)
            raise AssertionError(f"planted fault '{what}': its text is not once in {source}")
        cu.write_text(code.replace(text, replacement))
        copies.append(tmp)
    env = [{**os.environ, "PYTHONPATH": str(tmp)} for tmp in copies]
    builds = {i: subprocess.Popen(
        [sys.executable, "-c", "from vnsum_tpu_torch.ops import kernels; kernels.build_all()"],
        cwd=tmp, env=env[i], stdout=open(tmp / "build.log", "w"), stderr=subprocess.STDOUT)
        for i, tmp in enumerate(copies)}
    return {"root": root, "copies": copies, "env": env, "builds": builds,
            "t0": time.perf_counter()}


def phase_mutants(n_cases: int, started: dict) -> None:
    """Each planted fault of MUTANTS, built into a temporary copy of the
    package (start_mutant_builds), must run all ``n_cases`` cases of phase 3
    there, fail every case of its kernel and leave the cases of kernels
    outside its family passing: the limits see a kernel that leaves out one
    cache slot in 512 (decode, verify), one in 128 away from the causal
    diagonal (prefill, up to path (c)'s 32768 slots), the 512-slot split
    that holds the fill (decode's merge, down to the fill's one slot where a
    row sees little else), the last warp's 128 slots of a split's o
    (decode, verify) or a tile read from the wrong stage of the ring
    (prefill). The copies run four at a time: each holds 10-15 GB of caches
    at its peak, and with five at once one copy stopped short of its last
    cases in one run. A copy's run starts as soon as its build is done and
    fewer than four runs are under way, so one copy's start-up (the
    interpreter, torch, the card's context) overlaps the others' cases.
    Output goes to files: a run is never blocked on a full pipe. Logs each
    copy's build and run seconds, and how long each copy's phase 3 spent
    on the model-shard cases (``[phase3]`` lines)."""
    results = {}
    root, copies, env, builds = (started[k] for k in ("root", "copies", "env", "builds"))
    t0 = started["t0"]
    built, span = {}, {}
    running: dict = {}
    deadline = time.monotonic() + 1200
    try:
        while builds or running:
            for i, p in list(builds.items()):
                if len(running) == 4 or p.poll() is None:
                    continue
                del builds[i]
                built[i] = time.perf_counter() - t0
                if p.returncode != 0:
                    out = (copies[i] / "build.log").read_text()
                    raise AssertionError(f"planted fault '{MUTANTS[i][0]}' did not "
                                         f"build:\n{out[-4000:]}")
                span[i] = [time.perf_counter() - t0, None]
                running[i] = subprocess.Popen(
                    [sys.executable, "-c", "import torch, chip_smoke as c; "
                     "c.phase_environment(torch); c.phase_build(); "
                     "c.phase_correctness(torch)"],
                    cwd=copies[i], env=env[i], stdout=open(copies[i] / "out.log", "w"),
                    stderr=open(copies[i] / "err.log", "w"))
            for i, p in list(running.items()):
                if p.poll() is not None:
                    del running[i]
                    span[i][1] = time.perf_counter() - t0
                    results[i] = ((copies[i] / "out.log").read_text(),
                                  (copies[i] / "err.log").read_text(), p.returncode)
            if time.monotonic() > deadline:
                raise AssertionError("planted faults: the copies did not finish in 1200 s")
            time.sleep(0.2)
    finally:
        for p in [*builds.values(), *running.values()]:
            p.kill()
            p.wait(10)
        shutil.rmtree(root, ignore_errors=True)
    log("[mutant] copies (seconds since their builds started, during phase 3): "
        + "; ".join(f"{i}: built {built[i]:.1f}, ran {span[i][0]:.1f}-{span[i][1]:.1f}"
                    for i in sorted(span)))
    shard_s = []
    for i, (what, kernel, *_) in enumerate(MUTANTS):
        out, err, rc = results[i]
        shard_s += [float(ln.split()[-1][:-1]) for ln in out.splitlines()
                    if ln.startswith("[phase3] model-shard cases:")]
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
    if len(shard_s) != len(MUTANTS):
        raise AssertionError(f"planted faults: {len(shard_s)} copies timed their model-shard "
                             f"cases, of {len(MUTANTS)}")
    log(f"[mutant] the model-shard cases (phase 9g's, in phase 3): {min(shard_s):.2f}-"
        f"{max(shard_s):.2f}s a copy, {sum(shard_s):.2f}s over the {len(MUTANTS)} copies, "
        f"four at a time: ~{sum(shard_s) / 4:.1f}s of the phase's wall")


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
    # K2p at phase 9h's seq = 2 shard: C = LONG_MESH_SHARD, rank 0's pads
    rec = out["partials_shard"] = time_partials(
        torch, worst, False, C=LONG_MESH_SHARD, pads_h=(800, 5300), key="partials_shard",
        seed=90)
    log(f"[time] partials at a seq = 2 shard B=2 KV=8 C={LONG_MESH_SHARD}: kernel "
        f"{rec['ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}), plain "
        f"{rec['plain_ms']:.4f} ms, library {rec['library_ms']:.4f} ms (normalised output)")
    out["gemv"] = time_gemv(torch, worst)
    out.update(time_gemma_kernels(torch, worst))
    out.update(time_group4_kernels(torch, worst))
    out.update(time_shard_kernels(torch, worst))
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
    label = "model=2 shard" if tag == "_tp" else tag.replace("_hd", "hd=").replace("_g", "G=")
    case = (f"{label + ' ' if tag else ''}int8=True B={B}"
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


def time_shard_kernels(torch, worst) -> dict:
    """K1 and K2 on a model = 2 shard of Llama-3.2-3B's map batch (12 query
    heads on 4 KV heads a rank, head_dim 128): B=8, S=4096, C=4224, an int8
    cache of 28 layers, pads 64 b, K2 at fill 4200, through
    time_prefill_decode. Returns the two records."""
    dev = torch.device("cuda")
    L, B, KV, G, hd, S = 28, 8, 8 // 2, 3, 128, 4096
    pads_h = [64 * i for i in range(B)]
    cache = make_cache(torch, L, B, KV, S + 128, hd, True, 25, dev)
    lib = library_kv(torch, cache, 4, G)
    pre, dec = time_prefill_decode(
        torch, worst, "_tp", cache, lib, rand_q(torch, (B, S, KV * G, hd), 26, dev),
        rand_q(torch, (B, 1, KV * G, hd), 27, dev), pads_h, 4200, G, 0)
    for name, rec in (("prefill", pre), ("decode", dec)):
        log(f"[time] {name} model=2 shard (KV={KV}, H={KV * G}, C={S + 128}): kernel "
            f"{rec['ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}), plain "
            f"{rec['plain_ms']:.4f} ms, library {rec['library_ms']:.4f} ms")
    del cache, lib
    torch.cuda.empty_cache()
    return {"prefill_tp": pre, "decode_tp": dec}


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


def time_partials(torch, worst, quantized: bool, KV: int = 8, C: int = 32768,
                  pads_h=(0, 12000), key: str = "partials", seed: int = 70) -> dict:
    """K2p, its plain version and the library call at the long path's
    decode: B=2, the whole one-rank prefill cache of C=32768 slots read
    (fill = C - 1), pads 0 and 12000 (or another KV, C and pads: a
    shard's; one output held into ``worst[key]``). The library call computes the
    normalised output from a bf16 copy of the cache expanded to 24 heads.
    The bound counts each row's visible K/V slots (and int8 scales) read
    once, q read and (o, m, l) written once, and, on bf16 tensor cores, 2
    hd FLOP of QK and 2 x 2 hd of PV (p_hi and p_lo) per visible (query
    head, slot) pair. Pass 1 and the merge are timed apart (torch.profiler).
    One output is held against the plain version's as in phase 3."""
    from vnsum_tpu_torch.ops import decode_attention as da

    dev = torch.device("cuda")
    L, B, G, hd = 4, 2, 3, 128
    H = KV * G
    cache = long_cache(torch, L, B, KV, C, hd, quantized, range(L), seed + quantized, dev)
    pads_h = list(pads_h)
    pads = torch.tensor(pads_h, dtype=torch.int32, device=dev)
    q = rand_q(torch, (B, 1, H, hd), 71, dev)
    visible = sum(C - p for p in pads_h)
    elem = 1 if quantized else 2
    flops = 6 * hd * H * visible
    bytes_ = (q.numel() * 2 + 2 * visible * KV * (hd * elem + (4 if quantized else 0))
              + B * H * (hd + 2) * 4)
    ms = time_ms(torch, lambda i: da.flash_decode_partials(q, cache, i % L, pads, C - 1, G),
                 n=4 * L)
    decode_passes(torch, f"partials int8={quantized} B={B} KV={KV} C={C}", ms,
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
        torch, f"partials int8={quantized} B={B} KV={KV} C={C} pads={pads_h} layer={layer} "
        "(timing inputs)", da.flash_decode_partials(q, cache, layer, pads, C - 1, G),
        da.flash_decode_partials_ref(q, cache, layer, pads, C - 1, G),
        da.flash_decode_attention(q, cache, layer, pads, C - 1, G),
        float(cache_v_amax(cache, layer)), worst, key)
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
        # phase 9f (d): the runner's Tracer spans in the results JSON
        check_tracing(f"{label} results.tracing", res["results"]["tracing"])
        if label == "pipeline":
            PIPELINE_TRACING.update(res["results"]["tracing"])
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
GEMMA_LAYERS = 8
INT8_LAYERS = 4
# and of the Phi-4-14B phase (6b), whose 40 layers took 60-69 s of a run
# that the serve phase's tenant arms took past 600 s on a slower machine
PHI4_LAYERS = 4
# and of the Qwen3-8B phase (6c), 11.2 s at its 36 layers, when the fleet
# phase (9e, ~97 s) took the run past 600 s again
QWEN3_LAYERS = 6
# the checks phase (9f, ~15 s with its profile trace) took Gemma3 from 12
# layers to 8 (one global layer, at 5; at 6 its planted every-layer-global
# fault read 1.1x the gate's limit), Phi-4 from 12 to 4, Qwen3-8B from 12
# to 6 and the int8 and W8A8 pipelines from 7 to 4 (PERF.md §4)


def llama_int8_cut():
    from vnsum_tpu_torch.models import llama32_3b

    return llama32_3b(n_layers=INT8_LAYERS)


def gemma3_cut():
    """Gemma3-4B's config at GEMMA_LAYERS layers, every sixth global."""
    from vnsum_tpu_torch.models import gemma3_4b

    return gemma3_4b(n_layers=GEMMA_LAYERS,
                     layer_is_global=tuple((i + 1) % 6 == 0 for i in range(GEMMA_LAYERS)))


def phi4_cut():
    from vnsum_tpu_torch.models import phi4_14b

    return phi4_14b(n_layers=PHI4_LAYERS)


def qwen3_cut():
    from vnsum_tpu_torch.models import qwen3_8b

    return qwen3_8b(n_layers=QWEN3_LAYERS)


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
    """Phi-4-14B at its published width (dim 5120, 40/10 heads: GQA group
    4, head_dim 128, intermediate 17,920, vocab 100,352, untied head), cut
    to PHI4_LAYERS of its 40 layers (registry_depth), random bf16 weights
    from seed 0, byte tokenizer, FAMILY_NEW new tokens: (1) map-reduce
    through the CLI and its eager control (captured_and_eager), K1 =
    PHI4_LAYERS x prefill forwards and K2 = PHI4_LAYERS x decode steps
    exactly, K2p = K3 = GEMV = 0, every batch a GEMMA_SHAPES batch that
    phase 3 checked at group 4; (2) the dense logits gate
    (logits_gate, a row at a time) on the control's model, and one captured
    decode step profiled; (3) on the same model path (a) (spec_path: the
    spec pipeline and its oracle; K3 at Sq * G = 36 rows on every layer)
    and the one-step K3-against-K2 gate (step_kernel_gate), launches exact;
    (4) with that model freed, the CLI's map-reduce with --quantize
    (phase_int8_pipeline: the engine quantizes its bf16 init, as the JAX
    engine does; GEMV launches = gemv_need exactly), every document ok; (5)
    the fused checkpoint at 2 layers (phi_checkpoint). Returns the launches
    of (1), (3) and (4)."""
    with registry_depth(phi4_cut, "phi4:14b", "phi4-14b"):
        return phi4_paths(torch)


def phi4_paths(torch) -> dict:
    n_layers = PHI4_LAYERS
    docs = sorted((ROOT / "data/vi_eval/doc").glob("*.txt"))
    run = captured_and_eager(torch, "phi4:14b", phi4_cut, "phi4", FAMILY_NEW)
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
    """Qwen3-8B at its published width (dim 4096, 32/8 heads: GQA group
    4, head_dim 128, QK norm, intermediate 12,288, vocab 151,936, untied
    head), cut to QWEN3_LAYERS of its 36 layers (registry_depth), random
    bf16 weights from seed 0, byte tokenizer, FAMILY_NEW new tokens: the
    CLI's map-reduce, decode steps captured (captured_and_eager without the
    control: its capture and K3 shapes are what Llama's and Phi-4's phases
    check), K1 = QWEN3_LAYERS x prefill forwards and K2 = QWEN3_LAYERS x
    decode steps exactly, every batch a GEMMA_SHAPES batch; then the dense
    logits gate (a row at a time) on the same seed's model. Returns the CLI
    run's launches."""
    with registry_depth(qwen3_cut, "qwen3:8b", "qwen3-8b"):
        return qwen3_paths(torch)


def qwen3_paths(torch) -> dict:
    from vnsum_tpu_torch.backend.engine import TorchBackend

    n_layers = QWEN3_LAYERS
    run = captured_and_eager(torch, "qwen3:8b", qwen3_cut, "qwen3", FAMILY_NEW, eager=False)
    launches, eng = run["launches"], run["eng"]
    check_exact("qwen3", launches, {"prefill": n_layers * eng["prefill_forwards"],
                                    "decode": n_layers * eng["decode_steps"]},
                ("prefill", "decode"))
    check_batches("qwen3", eng)
    del run
    gc.collect()
    torch.cuda.empty_cache()
    engine = TorchBackend(qwen3_cut(), batch_size=8, max_new_tokens=FAMILY_NEW, device="cuda")
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
    prefill forwards and K2 = 28 x decode steps exactly. The checkpoint
    written here holds no tokenizer: the run uses the byte tokenizer on
    TorchBackend(model=loaded), as the pipeline phase did (phase 9d runs
    ``--weights-dir`` with a checkpoint's own tokenizer). The checkpoint is
    deleted at the end, also on failure. Returns the run's launches."""
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


# the hierarchical runs' model: Llama-3.2-3B at full width and 2 of its
# 28 layers. At full depth the eager control alone took ~88 s of the run
# (1808 host-bound steps), at 14 layers 49.5 s, at 4 layers 22.1 s (~1.5 ms
# a layer and ~6 ms a step besides); the cuts keep the whole run near half
# its time limit with Phi-4-14B's, Qwen3-8B's, the prefix cache's and the
# mesh's phases in it (PERF.md). The other three runs kept full depth until
# phase 9g's seconds had to be paid for. They run STRATEGY_CUT_LAYERS: at
# 14 layers the random model's summaries were too short for critique's
# collapse round at token_max 16, so critique's token_max is
# CRITIQUE_TOKEN_MAX, where a probe at 4 layers took collapse rounds
# [2, 1, 0, 0, 1, 1, 1] and the context pass in 5.4 s (at 28 layers and 16:
# [0, 0, 0, 0, 0, 1, 0] in 15.4 s; PERF.md)
HIERARCHICAL_LAYERS = 2
STRATEGY_CUT_LAYERS = 4
CRITIQUE_TOKEN_MAX = 4


def phase_strategies(torch) -> dict:
    """The four other approaches through PipelineRunner (Llama-3.2-3B;
    hierarchical on its own model cut to HIERARCHICAL_LAYERS layers),
    captured, each held to K1 = n_layers x prefill forwards and K2 =
    n_layers x decode steps exactly and no K2p or K3 launch, every batch at
    a shape phase 3 checked; critique at CRITIQUE_TOKEN_MAX, which must
    take a collapse round and the context pass; then hierarchical, whose
    batches vary most in (B, S),
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
    models = {"hierarchical": init_model(llama32_3b(n_layers=HIERARCHICAL_LAYERS), 0, dev),
              "cut": init_model(llama32_3b(n_layers=STRATEGY_CUT_LAYERS), 0, dev)}
    total = dict.fromkeys(COUNTERS, 0)
    by_shape = {"prefill": {}, "decode": {}}
    checked = set(PIPELINE_SHAPES) | set(STRATEGY_SHAPES)

    def run(approach: str, out: Path, trees: Path, cuda_graphs="auto"):
        model = models["hierarchical" if approach == "mapreduce_hierarchical" else "cut"]
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
            # the random model's summaries count a few whitespace tokens each
            argv += ["--token-max", str(CRITIQUE_TOKEN_MAX)]
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
                                     f"{context}; token_max {CRITIQUE_TOKEN_MAX} must take "
                                     "both")
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
# (c)'s judge model, a second random Llama-3.2-3B at full width whose free
# decode shows the CLI's plumbing only (its verdicts rarely parse): cut to
# JUDGE_CLI_LAYERS of its 28 layers to pay for phase 9i, its summarizer at
# full depth (its summaries must equal the pipeline phase's)
JUDGE_CLI_LAYERS = 4


def judge_cli_cut():
    from vnsum_tpu_torch.models import llama32_3b

    return llama32_3b(n_layers=JUDGE_CLI_LAYERS)


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
    judge, --judge-backend torch:llama3.2-3b (at JUDGE_CLI_LAYERS layers),
    free decode of up to 256 new tokens (LLMJudge's budget), captured.
    Returns the launches of (a)-(c)."""
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
            with registry_depth(judge_cli_cut, "llama3.2-3b"):
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
        need = {"prefill": n_layers * summarizer["prefill_forwards"]
                + JUDGE_CLI_LAYERS * jst.prefill_forwards,
                "decode": n_layers * summarizer["decode_steps"]
                + JUDGE_CLI_LAYERS * jst.decode_steps,
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
    log(f"[judge] CLI judge (c) --judge-backend torch:llama3.2-3b at {JUDGE_CLI_LAYERS} layers: "
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
    ONESHOT_ROWS[:] = rows
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


# the spec phase's one-shot map batch (128 new tokens, batch 8, captured
# steps): its generated id rows, the unmeshed reference of phase 9g (a)
ONESHOT_ROWS: list = []


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
              fused_runs=(1, 4), prompt_tokens: int = 4096, tokenizer: str = "byte",
              rows: dict | None = None) -> dict:
    """Path (b) on ``model``: TorchBackend.start_slot_loop(slots=8,
    prompt_tokens=``prompt_tokens``, max_new_tokens=max_new,
    segment_tokens=32) fed the map prompts in two waves and drained, at each
    of ``fused_runs``: every request completes, launches exactly n_layers x
    the join groups' prefill forwards (K1) and x the decode steps run (K3),
    no other kernel. Agreement with ``oneshot`` is logged, not gated. With
    ``rows``, each run's generated id rows by prompt index go into
    ``rows[fused]``. Returns the launches."""
    from vnsum_tpu_torch.backend.engine import TorchBackend

    n_layers = model.cfg.n_layers
    b = TorchBackend(model=model, tokenizer=tokenizer, batch_size=8, max_new_tokens=max_new,
                     segment_tokens=32, device="cuda")
    detokenized: list = []
    if rows is not None:
        detok = b._detok
        b._detok = lambda ids, extra_eos=(): detokenized.append(ids) or detok(ids, extra_eos)
    total = dict.fromkeys(COUNTERS, 0)
    texts = {}
    for fused in fused_runs:
        reset_launches()
        forwards0 = b.stats.prefill_forwards
        t0 = time.perf_counter()
        loop = b.start_slot_loop(slots=8, prompt_tokens=prompt_tokens, max_new_tokens=max_new,
                                 fused_segments=fused)
        outs: dict = {}
        ids: dict = {}
        adm, rej = loop.admit([(i, prompts[i], None) for i in range(3)])
        if rej or len(adm) != 3:
            raise AssertionError(f"first wave: {len(adm)} admitted, {rej} rejected")
        pending = list(range(3, len(prompts)))
        for _ in range(64):
            n0 = len(detokenized)
            # a step detokenizes its completions in their order
            for j, c in enumerate(loop.step().completions):
                outs[c.key] = c.text
                if rows is not None:
                    ids[c.key] = detokenized[n0 + j]
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
        if rows is not None:
            rows[fused] = {i: trimmed_ids(b, ids[i]) for i in ids}
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


def cache_arm(torch, b, label: str, prompts: list, hints, spy, rows: dict | None = None) -> dict:
    """One generate call of ``prompts`` on ``b``: launches exactly
    n_layers x the call's prefill forwards (K1) and decode steps (K2), no
    other kernel; its decode steps captured; with the prefix cache on, the
    per-prompt report, the hit and miss counters and the index's stats
    consistent with one another, no pin left. Logs hits, misses, prefill,
    gather and insert seconds, the pool's bytes, peak memory and K. With
    ``rows``, the call's generated id rows by prompt index go into it."""
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
    kw = {"cache_hints": None if hints is None else [hints] * len(prompts)}
    if rows is None:
        texts = b.generate(prompts, **kw)
    else:
        texts, got = generate_rows(b, prompts, **kw)
        rows.update(got)
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


def serve_request(method: str, url: str, payload=None, timeout: float = 600.0,
                  headers: dict | None = None, response_headers: list | None = None):
    """(status, decoded JSON or raw text) of one HTTP exchange; an HTTP
    error status is returned, not raised. ``headers`` are added to the
    request's; with ``response_headers``, the response's headers are
    appended to it."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json",
                                          **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            status, raw, got = resp.status, resp.read(), resp.headers
    except urllib.error.HTTPError as e:
        status, raw, got = e.code, e.read(), e.headers
    if response_headers is not None:
        response_headers.append(dict(got))
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
    threads, replies, _ = post_in_order(base, payloads)
    join_posts(threads)
    return replies


def journal_line(torch, arm: str, state, wall: float, replay_s: float) -> None:
    """The durable and streaming arms' ``[serve]`` line: wall, the journal's
    re-enqueue seconds, records, bytes and fsyncs, and peak memory."""
    js = state.journal.stats_dict()
    replay = (f", replay {replay_s:.3f}s to drain ({js['replay_seconds']:.6f}s to re-enqueue "
              f"{js['replayed']})" if js["replayed"] else "")
    log(f"[serve] {arm}: wall {wall:.3f}s{replay}, journal {js['records']} records, "
        f"{js['appended_bytes']} bytes, {js['fsyncs']} fsyncs, pending {js['pending']}, "
        f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")


def metric_value(text: str, name: str):
    """The value of an unlabelled series in a /metrics text, or None."""
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[-1])
    return None


def wait_pending(state, timeout_s: float = 600.0) -> float:
    """Seconds until the state's journal owes nothing; raises past the limit."""
    t0 = time.perf_counter()
    while state.journal.pending():
        if time.perf_counter() - t0 > timeout_s:
            raise AssertionError(f"serve: journal still pending {state.journal.pending()}")
        time.sleep(0.01)
    return time.perf_counter() - t0


def write_unfinished(directory: Path, prompts: list, prefix: str) -> None:
    """A journal left by a life that accepted ``prompts`` and died before
    its scheduler dispatched them: the ACCEPTs, no terminal record, no
    seal."""
    from vnsum_tpu_torch.serve.journal import RequestJournal
    from vnsum_tpu_torch.serve.queue import ServeRequest

    j = RequestJournal(directory)
    for i, prompt in enumerate(prompts):
        j.accept(ServeRequest(prompt=prompt, max_new_tokens=SERVE_NEW, trace_id=f"{prefix}-{i}"))
    j.close()


def serve_durable(torch, backend, prompts: list, oneshot: list, n_layers: int, add) -> None:
    """Arm (e) of 9c: durable serving. Life 1 journals and answers the 7 map
    prompts, its poll surface giving back each text; a journal left with
    the 7 ACCEPTs unfinished is replayed by a fresh ServeState through the
    micro-batch scheduler (one engine batch in journal order, every text
    equal to the direct generate, K1/K2 exact, a second replay enqueues
    nothing) and, from a copy, through the in-flight scheduler."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # life 1: journaled serving and the poll surface
        b = backend()
        with serving(b, max_wait_s=SERVE_WAIT_S, journal_dir=str(tmp / "life1")) as (base, state):
            state.replay_journal()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            forwards0, steps0 = b.stats.prefill_forwards, b.stats.decode_steps
            t0 = time.perf_counter()
            status, body = serve_request("POST", base + "/v1/generate", {
                "prompts": prompts, "max_new_tokens": SERVE_NEW, "request_id": "e-life1"})
            wall = time.perf_counter() - t0
            launches = read_launches()
            if status != 200:
                raise AssertionError(f"serve (e) life 1: HTTP {status}: {body}")
            status, poll = serve_request("GET", base + "/v1/requests/e-life1")
            texts = [e.get("text") for e in poll.get("entries", [])] if status == 200 else []
            if status != 200 or poll["status"] != "completed" or texts != oneshot:
                raise AssertionError(f"serve (e) life 1: poll {status} "
                                     f"{poll if status != 200 else poll['status']}, "
                                     f"{agreement(texts, oneshot)}")
            _, text = serve_request("GET", base + "/metrics")
            records = metric_value(text, "vnsum_serve_journal_records_total")
            if not records or metric_value(text, "vnsum_serve_journal_pending") != 0:
                raise AssertionError(f"serve (e) life 1: /metrics journal records {records}, "
                                     f"pending {metric_value(text, 'vnsum_serve_journal_pending')}")
            check_exact("serve (e) durable, life 1", launches, {
                "prefill": n_layers * (b.stats.prefill_forwards - forwards0),
                "decode": n_layers * (b.stats.decode_steps - steps0)},
                path_kernels=("prefill", "decode"))
            add(launches)
            log(f"[serve] (e) life 1: GET /v1/requests/e-life1 {poll['status']}, "
                f"{len(texts)} texts byte-identical to the direct generate, /metrics journal "
                f"records {records:.0f}, pending 0")
            journal_line(torch, "(e) life 1", state, wall, 0.0)
        del b
        # the journal a crash before dispatch leaves, twice (one per replay)
        write_unfinished(tmp / "crashed", prompts, "e-replay")
        shutil.copytree(tmp / "crashed", tmp / "crashed_inflight")
        unfinished_bytes = sum(f.stat().st_size for f in (tmp / "crashed").iterdir())
        # life 2: replay through the micro-batch scheduler
        b = backend()
        with serving(b, max_wait_s=SERVE_WAIT_S, journal_dir=str(tmp / "crashed")) as (
                base, state):
            ready = serve_request("GET", base + "/readyz")
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            forwards0, steps0 = b.stats.prefill_forwards, b.stats.decode_steps
            t0 = time.perf_counter()
            n = state.replay_journal()
            replay_s = wait_pending(state)
            wall = time.perf_counter() - t0
            launches = read_launches()
            again = state.replay_journal()
            entries = [state.journal.lookup(f"e-replay-{i}") for i in range(len(prompts))]
            texts = [e[0].text if len(e) == 1 else None for e in entries]
            statuses = {e[0].status for e in entries if e}
            _, text = serve_request("GET", base + "/metrics")
            replayed = metric_value(text, "vnsum_serve_journal_replayed_total")
            if (ready[0] != 503 or ready[1].get("reason") != "pre_replay" or n != len(prompts)
                    or again != 0 or statuses != {"complete"} or replayed != len(prompts)):
                raise AssertionError(f"serve (e) replay: readyz before replay {ready}, "
                                     f"replayed {n} then {again}, statuses {statuses}, "
                                     f"/metrics replayed {replayed}")
            if texts != oneshot:
                raise AssertionError(f"serve (e) replay: texts differ from the direct generate "
                                     f"({state.metrics.snapshot().batches} engine batches): "
                                     f"{agreement(texts, oneshot)}")
            check_exact("serve (e) durable, replay", launches, {
                "prefill": n_layers * (b.stats.prefill_forwards - forwards0),
                "decode": n_layers * (b.stats.decode_steps - steps0)},
                path_kernels=("prefill", "decode"))
            add(launches)
            log(f"[serve] (e) replay: /readyz {ready[1]['reason']} before replay, "
                f"replay_journal() {n} then {again}, {len(texts)} texts byte-identical to the "
                f"direct generate in {state.metrics.snapshot().batches} engine batch(es), "
                f"/metrics journal_replayed_total {replayed:.0f}, unfinished journal "
                f"{unfinished_bytes} bytes")
            journal_line(torch, "(e) replay", state, wall, replay_s)
        del b
        # the same unfinished journal through the in-flight scheduler
        b = backend()
        loops = spy_loops(b)
        with serving(b, max_wait_s=0.01, inflight=True, slots=8, slot_prompt_tokens=4096,
                     journal_dir=str(tmp / "crashed_inflight")) as (base, state):
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            forwards0 = b.stats.prefill_forwards
            t0 = time.perf_counter()
            n = state.replay_journal()
            replay_s = wait_pending(state)
            wall = time.perf_counter() - t0
            launches = read_launches()
            entries = [state.journal.lookup(f"e-replay-{i}") for i in range(len(prompts))]
            statuses = {e[0].status for e in entries if e}
            if n != len(prompts) or statuses != {"complete"}:
                raise AssertionError(f"serve (e) in-flight replay: replayed {n}, statuses "
                                     f"{statuses}")
            check_exact("serve (e) durable, in-flight replay", launches, {
                "prefill": n_layers * (b.stats.prefill_forwards - forwards0),
                "verify": n_layers * sum(loop.decode_steps for loop in loops)})
            add(launches)
            texts = [e[0].text for e in entries]
            log(f"[serve] (e) in-flight replay: {n} entries complete through {len(loops)} slot "
                f"loop(s), {sum(loop.decode_steps for loop in loops)} decode steps; against "
                f"the direct generate: {agreement(texts, oneshot)} (not gated)")
            journal_line(torch, "(e) in-flight replay", state, wall, replay_s)


# the streaming arm's chunk size: a data/vi_eval document splits into 4-5
# map chunks of 646-1272 tokens (map prompts of S = 2048 at B = 4, or B = 8
# for two documents; the reduce at S <= 1024), shapes phase 3 checks
SERVE_CHUNK = 1024


def spy_rounds(events: list):
    """QueuedBackend's submit_round, harvest and generate, recording each
    call in ``events`` in order; returns the undo."""
    from vnsum_tpu_torch.serve.scheduler import QueuedBackend

    saved = {name: getattr(QueuedBackend, name) for name in ("submit_round", "harvest", "generate")}

    def submit_round(self, prompts, *, phase="map", **kw):
        events.append(("submit", phase, len(prompts)))
        return saved["submit_round"](self, prompts, phase=phase, **kw)

    def harvest(self, fut, **kw):
        out = saved["harvest"](self, fut, **kw)
        events.append(("harvest",))
        return out

    def generate(self, prompts, **kw):
        events.append(("generate", len(prompts)))
        return saved["generate"](self, prompts, **kw)

    QueuedBackend.submit_round, QueuedBackend.harvest = submit_round, harvest
    QueuedBackend.generate = generate

    def undo():
        for name, fn in saved.items():
            setattr(QueuedBackend, name, fn)

    return undo


def serve_streaming(torch, backend, n_layers: int, add) -> None:
    """Arm (f) of 9c: POST /v1/summarize (mapreduce) of a data/vi_eval
    document that splits into 4 chunks at SERVE_CHUNK tokens. The
    strategy's rounds stream over the QueuedBackend: the reduce is
    submitted from harvest as the last map child lands (the recorded call
    order; no barrier generate), and the journal's GANG records give the
    poll surface its map and reduce phases. The summary equals the barrier
    route's (summarize_batch on a plain TorchBackend) byte for byte: with one
    document, the map round and the reduce round are the same engine
    batches on both routes. Then two documents as two concurrent requests.
    The server serves mapreduce at SERVE_CHUNK through its own setting,
    ServeState(pipeline_overrides=...), and the barrier route runs the
    strategy the server built."""
    import threading

    paths = sorted((ROOT / "data/vi_eval/doc").glob("*.txt"))[:2]
    docs = [p.read_text(encoding="utf-8") for p in paths]
    b = backend()
    with tempfile.TemporaryDirectory() as tmp, serving(
            b, max_wait_s=SERVE_WAIT_S, journal_dir=tmp,
            pipeline_overrides={"chunk_size": SERVE_CHUNK,
                                "max_new_tokens": SERVE_NEW}) as (base, state):
        state.replay_journal()
        strategy = state.strategy_for("mapreduce")
        chunks = [len(strategy.splitter.split_text(d)) for d in docs]
        if min(chunks) < 3:
            raise AssertionError(f"serve (f): chunks per document {chunks}, want >= 3")
        plain = backend()
        barrier = [strategy.summarize_batch([d], backend=plain)[0].summary for d in docs]
        del plain
        events: list = []
        undo = spy_rounds(events)
        try:
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            forwards0, steps0 = b.stats.prefill_forwards, b.stats.decode_steps
            t0 = time.perf_counter()
            status, body = serve_request("POST", base + "/v1/summarize", {
                "text": docs[0], "approach": "mapreduce", "request_id": "f-one"})
            wall = time.perf_counter() - t0
            launches = read_launches()
        finally:
            undo()
        if status != 200 or body.get("summary") is None:
            raise AssertionError(f"serve (f): HTTP {status}: {body}")
        n_maps = chunks[0]
        want = ([("submit", "map", n_maps)] + [("harvest",)] * n_maps
                + [("submit", "reduce", 1), ("harvest",)])
        if events != want:
            raise AssertionError(f"serve (f): rounds {events}, want {want}")
        status, poll = serve_request("GET", base + "/v1/requests/f-one")
        phases = (poll.get("gang") or {}).get("phases", {}) if status == 200 else {}
        if (status != 200 or poll["status"] != "completed"
                or {k: v["done"] for k, v in phases.items()} != {"map": n_maps, "reduce": 1}):
            raise AssertionError(f"serve (f): poll {status} {poll}")
        if body["summary"] != barrier[0]:
            raise AssertionError(f"serve (f): the streamed summary differs from the barrier "
                                 f"route's: {agreement([body['summary']], barrier[:1])}")
        check_exact("serve (f) streaming summarize", launches, {
            "prefill": n_layers * (b.stats.prefill_forwards - forwards0),
            "decode": n_layers * (b.stats.decode_steps - steps0)},
            path_kernels=("prefill", "decode"))
        add(launches)
        log(f"[serve] (f) streaming summarize {paths[0].name}: 200, {body['num_chunks']} "
            f"chunks, {body['llm_calls']} LLM calls, rounds {events[0]} then "
            f"{n_maps} harvests then {events[n_maps + 1]} from harvest, no barrier generate; "
            f"poll phases {phases}; summary ({len(body['summary'])} chars) byte-identical "
            f"to the barrier route's")
        journal_line(torch, "(f) streaming summarize", state, wall, 0.0)
        # two documents, two concurrent requests
        replies = [None, None]

        def run(i):
            replies[i] = serve_request("POST", base + "/v1/summarize", {
                "text": docs[i], "approach": "mapreduce", "request_id": f"f-pair-{i}"})

        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        forwards0, steps0 = b.stats.prefill_forwards, b.stats.decode_steps
        batches0 = state.metrics.snapshot().batches
        t0 = time.perf_counter()
        threads = [threading.Thread(target=run, args=(i,), daemon=True) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        launches = read_launches()
        if any(t.is_alive() for t in threads) or [r[0] for r in replies] != [200, 200]:
            raise AssertionError(f"serve (f) pair: replies {[r and r[0] for r in replies]}")
        check_exact("serve (f) two concurrent summarizes", launches, {
            "prefill": n_layers * (b.stats.prefill_forwards - forwards0),
            "decode": n_layers * (b.stats.decode_steps - steps0)},
            path_kernels=("prefill", "decode"))
        add(launches)
        summaries = [r[1]["summary"] for r in replies]
        log(f"[serve] (f) pair: 2/2 200 in {state.metrics.snapshot().batches - batches0} "
            f"engine batches, chunks {chunks}; against the barrier route: "
            f"{agreement(summaries, barrier)} (not gated)")
        journal_line(torch, "(f) pair", state, wall, 0.0)


# arm (g) of 9c, tenants and SLOs (ROADMAP A15b-2). Every server of the arm
# declares QOS_TENANTS: an interactive tenant of weight 4 and a batch-tier
# one of weight 1, neither rate-limited. (g3)'s quota shed is the metered
# tenant's (10 tokens/s, a burst of 20) and its SLO spec holds a loose
# objective and one no request meets. (g2) runs at the serve phase's 64 new
# tokens (QOS_NEW, C = S + 64 as arms (b), (c) and (e)) and phase 9d's
# preemption arm at the fixture's 128, both in 8-step segments
# (QOS_SEGMENT_TOKENS): the in-flight scheduler takes what is queued when
# its loop is empty, so 8 requests arriving together join over up to four
# boundaries (1, then 4, 2, 1 of them), and a row must outlive those and
# the interactive requests' arrival (at 32-step segments and 64 tokens the
# first joiner would be done before the last joined). Each of their batch-tier
# prompts starts with its own tag (QOS_TAG), so no join resumes over
# another row's blocks: a join is cold (K1 at q_offset 0) unless it is an
# evictee's. (g1)'s primer is a request of another batch key (fewer new
# tokens) whose coalescing window (QOS_WINDOW_S) the 12 requests arrive in,
# so the engine's first batch of them is a pick from all 12
QOS_TENANTS = "ui:4:0,bulk:1:0:batch"
QOS_METERED = "metered:1:10"
QOS_SLO = "e2e_p99=600,ttft_p99=0.001"
QOS_PREEMPT_BUDGET = 4
QOS_NEW = SERVE_NEW
QOS_SEGMENT_TOKENS = 8
QOS_TAG = "Yêu cầu số {}.\n"
QOS_PRIMER_NEW = 32
QOS_WINDOW_S = 0.5


def post_in_order(base: str, payloads: list, tenants: list | None = None,
                  state=None) -> tuple:
    """POST each payload to /v1/generate from its own thread, with its
    X-Tenant header when ``tenants`` names one; with ``state``, each is
    started once the one before it is queued (the queue's depth has grown
    by one). Returns (threads, replies, the perf_counter second each reply
    ended)."""
    import threading

    replies, ends = [None] * len(payloads), [None] * len(payloads)

    def run(i):
        replies[i] = serve_request("POST", base + "/v1/generate", payloads[i],
                                   headers={"X-Tenant": tenants[i]} if tenants else None)
        ends[i] = time.perf_counter()

    threads = []
    depth0 = state.scheduler.queue.depth if state is not None else 0
    for i in range(len(payloads)):
        threads.append(threading.Thread(target=run, args=(i,), daemon=True))
        threads[-1].start()
        t_end = time.perf_counter() + 10
        while state is not None and state.scheduler.queue.depth < depth0 + i + 1:
            if time.perf_counter() > t_end:
                raise AssertionError(f"serve: request {i} not queued within 10 s")
            time.sleep(0.001)
    return threads, replies, ends


def join_posts(threads: list) -> None:
    for t in threads:
        t.join(timeout=900)
    if any(t.is_alive() for t in threads):
        raise AssertionError("serve: a client thread never got its reply")


def spy_admissions(b) -> list:
    """Every admission of every slot loop ``b.start_slot_loop`` opens, in
    order, as (request id, prompt tokens the join skipped)."""
    admissions = []
    start = b.start_slot_loop

    def spy(*args, **kw):
        loop = start(*args, **kw)
        admit = loop.admit

        def admit_spy(items):
            adm, rej = admit(items)
            admissions.extend((a.key.trace_id, a.cached_tokens) for a in adm)
            return adm, rej

        loop.admit = admit_spy
        return loop

    b.start_slot_loop = spy
    return admissions


def journal_events(directory: str, kinds: tuple) -> dict:
    """{kind: [rid, ...]} of a journal's records of ``kinds``, in order."""
    out = {k: [] for k in kinds}
    for seg in sorted(Path(directory).glob("journal.*.jsonl")):
        for line in seg.read_bytes().splitlines():
            rec = json.loads(line[9:])
            if rec.get("e") in out:
                out[rec["e"]].append(rec["rid"])
    return out


def serve_tenants(torch, model, prompts: list, n_layers: int, add) -> int:
    """Arm (g) of 9c: tenants and SLOs. Returns the K1 launches of its
    resumed forwards."""
    from vnsum_tpu_torch.backend.engine import TorchBackend
    from vnsum_tpu_torch.serve.qos import TenantTable, parse_tenant_specs
    from vnsum_tpu_torch.serve.queue import ServeRequest

    spec = f"{QOS_TENANTS},{QOS_METERED}"
    # (g1) the weighted-fair pick on the micro-batch scheduler: a primer,
    # then 8 bulk and 4 ui requests queued in its window, in that order
    b = TorchBackend(model=model, batch_size=8, max_new_tokens=SERVE_NEW, segment_tokens=32,
                     device="cuda")
    rows = [(f"g1-bulk-{i}", "bulk", "batch", prompts[i % len(prompts)]) for i in range(8)]
    rows += [(f"g1-ui-{j}", "ui", "interactive", prompts[i])
             for j, i in enumerate((1, 3, 5, 6))]
    cands = [ServeRequest(prompt=p, tenant=t, tier=tier, est_tokens=b.count_tokens(p),
                          trace_id=rid) for rid, t, tier, p in rows]
    want = [r.trace_id for r in TenantTable(parse_tenant_specs(spec)).select(cands, 8)]
    want = [["g1-primer"], want, [rid for rid, *_ in rows if rid not in want]]
    prompt_of = {rid: p for rid, _, _, p in rows}
    prompt_of["g1-primer"] = prompts[0]
    with tempfile.TemporaryDirectory() as flight, serving(
            b, max_wait_s=QOS_WINDOW_S, tenants=TenantTable(parse_tenant_specs(spec)),
            slo=QOS_SLO, flight_dir=flight) as (base, state):
        takes = []
        on_take = state.scheduler.queue.on_take

        def spy_take(batch):
            # runs under the queue lock: the depth it leaves, read unlocked
            takes.append(([r.trace_id for r in batch], len(state.scheduler.queue._items)))
            on_take(batch)

        state.scheduler.queue.on_take = spy_take
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        forwards0, steps0 = b.stats.prefill_forwards, b.stats.decode_steps
        t0 = time.perf_counter()
        payloads = [{"prompt": prompts[0], "max_new_tokens": QOS_PRIMER_NEW,
                     "request_id": "g1-primer"}]
        payloads += [{"prompt": p, "max_new_tokens": SERVE_NEW, "request_id": rid}
                     for rid, _, _, p in rows]
        threads, replies, _ = post_in_order(base, payloads, ["ui"] + [r[1] for r in rows], state)
        join_posts(threads)
        wall = time.perf_counter() - t0
        launches = read_launches()
        if [s for s, _ in replies] != [200] * len(payloads):
            raise AssertionError(f"serve (g1): statuses {[s for s, _ in replies]}")
        if [t for t, _ in takes] != want or takes[0][1] != len(rows):
            raise AssertionError(f"serve (g1): engine batches {takes}, TenantTable.select "
                                 f"over the 12 queued gives {want}")
        check_exact("serve (g1) weighted-fair pick", launches, {
            "prefill": n_layers * (b.stats.prefill_forwards - forwards0),
            "decode": n_layers * (b.stats.decode_steps - steps0)},
            path_kernels=("prefill", "decode"))
        add(launches)
        served = {p["request_id"]: r[1]["completions"][0]["text"]
                  for p, r in zip(payloads, replies)}
        serve_line(torch, "(g1) weighted-fair pick", state, len(payloads), wall)

        # (g3) on the same server, host-only: a quota shed, an unknown
        # tenant, the SLO engine's verdict and its breach dump
        metered = state.tenants.resolve("metered")
        t_drain = time.perf_counter()
        if state.tenants.admit("metered", metered.burst) is not None:
            raise AssertionError("serve (g3): the metered bucket did not start full")
        got = []
        status, body = serve_request("POST", base + "/v1/generate",
                                     {"prompt": prompts[0], "max_new_tokens": SERVE_NEW},
                                     headers={"X-Tenant": "metered"}, response_headers=got)
        elapsed = time.perf_counter() - t_drain
        exact = min(b.count_tokens(prompts[0]), metered.burst) / metered.token_rate
        retry = body.get("retry_after_s", -1.0) if isinstance(body, dict) else -1.0
        if (status != 429 or body.get("reason") != "quota"
                or not exact - elapsed <= retry <= exact
                or got[0].get("Retry-After") != str(max(1, int(round(retry))))):
            raise AssertionError(f"serve (g3) quota: {status} {body}, Retry-After "
                                 f"{got[0].get('Retry-After')}, the refill arithmetic gives "
                                 f"{exact:.3f} s less at most {elapsed:.3f} s refilled")
        status_u, body_u = serve_request("POST", base + "/v1/generate", {"prompt": "ai đó"},
                                         headers={"X-Tenant": "khong-co"})
        if status_u != 400 or not str(body_u.get("error", "")).startswith("unknown tenant"):
            raise AssertionError(f"serve (g3) unknown tenant: {status_u} {body_u}")
        t_end = time.perf_counter() + 10
        while True:
            _, slo = serve_request("GET", base + "/debug/slo")
            dumps = sorted(Path(flight).glob("flight_slo_fast_burn_*.json"))
            if dumps or time.perf_counter() > t_end:
                break
            time.sleep(0.05)
        _, fr = serve_request("GET", base + "/debug/flightrecorder")
        _, health = serve_request("GET", base + "/healthz")
        _, text = serve_request("GET", base + "/metrics")
        loose, tight = slo["objectives"]["e2e_p99"], slo["objectives"]["ttft_p99"]
        breaches = [e for e in fr["events"] if e["kind"] == "slo_breach"]
        dumped = json.loads(dumps[0].read_text()) if dumps else {}
        if (loose["compliance"] != 1.0 or loose["breaching"] or not tight["breaching"]
                or tight["burn_fast"] < slo["config"]["breach_fast_burn"]
                or tight["burn_slow"] < slo["config"]["breach_slow_burn"]
                or [e.get("objective") for e in breaches] != ["ttft_p99"] or len(dumps) != 1
                or not any(e["kind"] == "slo_breach" for e in dumped.get("events", []))
                or not str(health.get("slo", "")).startswith("BREACH ttft_p99")
                or metric_value(text, "vnsum_serve_slo_breached") != 1
                or 'vnsum_serve_slo_burn_rate{objective="ttft_p99",window="fast"}' not in text
                or 'vnsum_serve_qos_quota_sheds_total{tenant="metered"} 1' not in text):
            raise AssertionError(f"serve (g3) SLOs: /debug/slo {slo}, slo_breach events "
                                 f"{breaches}, dumps {[d.name for d in dumps]}, /healthz slo "
                                 f"{health.get('slo')}")
        log(f"[serve] (g3) quota: 429 quota, Retry-After {got[0]['Retry-After']} "
            f"(retry_after_s {retry:.4f}, refill arithmetic {exact:.4f} s less at most "
            f"{elapsed:.4f} s), unknown tenant 400; SLOs: e2e_p99 compliance "
            f"{loose['compliance']:.3f}, ttft_p99 burn fast {tight['burn_fast']:.1f} slow "
            f"{tight['burn_slow']:.1f}, one slo_breach, dump {dumps[0].name}, /healthz "
            f"{health['slo']!r}")
    # the direct generate of each engine batch's rows, on the idle backend
    for batch in want:
        new = QOS_PRIMER_NEW if batch == ["g1-primer"] else SERVE_NEW
        direct = b.generate([prompt_of[rid] for rid in batch], max_new_tokens=new)
        if [served[rid] for rid in batch] != direct:
            raise AssertionError(f"serve (g1): batch {batch} differs from the direct generate: "
                                 f"{agreement([served[rid] for rid in batch], direct)}")
    log(f"[serve] (g1) weighted-fair pick: engine batches {[t for t, _ in takes]} (the "
        f"first taken with {takes[0][1]} queued), each equal to TenantTable.select's pick, "
        f"every text byte-identical to the direct generate of its batch")
    del b

    # (g2) in-flight tier preemption over the prefix cache
    b = TorchBackend(model=model, batch_size=8, max_new_tokens=QOS_NEW,
                     segment_tokens=QOS_SEGMENT_TOKENS, device="cuda", cache_blocks=CACHE_BLOCKS,
                     cache_block_tokens=CACHE_BLOCK_TOKENS)
    loops = spy_loops(b)
    spy = spy_cache(torch, b)
    admissions = spy_admissions(b)
    docs = sorted((ROOT / "data/vi_eval/doc").glob("*.txt"))
    bulk = [(f"g2-bulk-{i}", QOS_TAG.format(i) + p) for i, p in enumerate(prompts + prompts[:1])]
    ui = [(f"g2-ui-{j}", "Trả lời ngắn gọn: " + d.read_text(encoding="utf-8")[:600])
          for j, d in enumerate(docs[:2])]
    with tempfile.TemporaryDirectory() as jdir, serving(
            b, max_wait_s=SERVE_WAIT_S, inflight=True, slots=8, slot_prompt_tokens=4096,
            tenants=TenantTable(parse_tenant_specs(QOS_TENANTS)),
            journal_dir=jdir) as (base, state):
        state.replay_journal()
        state.scheduler.preempt_budget = QOS_PREEMPT_BUDGET
        evictions = []
        requeue = state.scheduler._requeue_eviction

        def spy_requeue(ev):
            evictions.append((ev.key.trace_id, loops[-1].segments, ev.pin is not None))
            requeue(ev)

        state.scheduler._requeue_eviction = spy_requeue
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        forwards0 = b.stats.prefill_forwards
        t0 = time.perf_counter()
        b_threads, b_replies, b_ends = post_in_order(base, [
            {"prompt": p, "max_new_tokens": QOS_NEW, "request_id": rid} for rid, p in bulk],
            ["bulk"] * len(bulk))
        t_end = time.perf_counter() + 300
        while (state.scheduler.slot_state() or (0, 0))[1] < len(bulk):
            if time.perf_counter() > t_end or not all(t.is_alive() for t in b_threads):
                raise AssertionError(f"serve (g2): slots {state.scheduler.slot_state()}")
            time.sleep(0.001)
        seg_at_ui = loops[-1].segments
        u_threads, u_replies, u_ends = post_in_order(base, [
            {"prompt": p, "max_new_tokens": QOS_NEW, "request_id": rid} for rid, p in ui],
            ["ui"] * len(ui))
        join_posts(b_threads + u_threads)
        wall = time.perf_counter() - t0
        launches = read_launches()
        statuses = [s for s, _ in b_replies + u_replies]
        evictees = [rid for rid, _, _ in evictions]
        snap = state.metrics.snapshot()
        _, text = serve_request("GET", base + "/metrics")
        wait_pending(state)
        events = journal_events(jdir, ("preempted", "requeued"))
        rejoins = [(rid, cached) for rid, cached in admissions if rid in evictees]
        resumed_K = sorted({K for K in spy["K"] if K})
        ui_first = [u_ends[j] - (r[1]["completions"][0]["record"]["total_s"]
                                 - r[1]["completions"][0]["record"]["ttft_s"])
                    for j, r in enumerate(u_replies)]
        if (statuses != [200] * len(statuses) or len(set(evictees)) != 2
                or (snap.preemptions, snap.requeues) != (2, 2)
                or metric_value(text, "vnsum_serve_qos_preemptions_total") != 2
                or metric_value(text, "vnsum_serve_qos_requeues_total") != 2
                or not all(pinned and 0 <= seg - seg_at_ui <= 1
                           for _, seg, pinned in evictions)
                or sorted(events["preempted"]) != sorted(evictees)
                or sorted(events["requeued"]) != sorted(evictees)
                or len(rejoins) != 4 or not all(cached > 0 for _, cached in rejoins[2:])
                or not resumed_K or not set(resumed_K) <= set(RESUME_OFFSETS)
                or not spy["resume_launches"] or max(ui_first) >= max(b_ends)):
            raise AssertionError(
                f"serve (g2): statuses {statuses}, evictions (rid, loop segments, pinned) "
                f"{evictions} against {seg_at_ui} segments when ui arrived, preemptions / "
                f"requeues {snap.preemptions} / {snap.requeues}, journal {events}, "
                f"evictee admissions {rejoins}, resumed K {resumed_K}, K1 resumed launches "
                f"{spy['resume_launches']}, ui first tokens {ui_first} against the last bulk "
                f"reply {max(b_ends)}")
        check_exact("serve (g2) tier preemption", launches, {
            "prefill": n_layers * (b.stats.prefill_forwards - forwards0),
            "verify": n_layers * sum(loop.decode_steps for loop in loops)})
        add(launches)
        texts = {r[1]["completions"][0]["record"]["trace_id"]: r[1]["completions"][0]["text"]
                 for r in b_replies}
        log(f"[serve] (g2) tier preemption: 8 bulk residents, ui arrived at {seg_at_ui} "
            f"segments, evicted {evictees} at {[seg for _, seg, _ in evictions]} (pinned), "
            f"journal PREEMPTED {events['preempted']} REQUEUED {events['requeued']}, re-joins "
            f"{rejoins[2:]} prompt tokens skipped at K {resumed_K}, K1 launches at the resume "
            f"shape {spy['resume_launches']}, ui first tokens "
            f"{[round(t - t0, 3) for t in ui_first]} s before the last bulk reply at "
            f"{max(b_ends) - t0:.3f} s")
        serve_line(torch, "(g2) tier preemption", state, len(bulk) + len(ui), wall)
    resume_launches = spy["resume_launches"]
    del b, loops, spy
    control = TorchBackend(model=model, batch_size=8, max_new_tokens=QOS_NEW, device="cuda")
    by_rid = dict(bulk)
    oneshot = control.generate([by_rid[rid] for rid in evictees])
    log(f"[serve] (g2) evictees against the one-shot run: "
        f"{agreement([texts[rid] for rid in evictees], oneshot)} (not gated)")
    return resume_launches


def phase_serve(torch, model) -> tuple[dict, int, tuple]:
    """The serving slice on Llama-3.2-3B (``model``: the spec phase's, full
    width and depth, random bf16 weights, int8 cache): arms (a)-(g) of the
    module docstring's 9c. Returns (the phase's launches, K1 launches of
    resumed forwards, (the map prompts, their direct generate's texts): the
    fleet phase's reference)."""
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
    del b, loops
    serve_durable(torch, backend, prompts, oneshot, n_layers, add)
    serve_streaming(torch, backend, n_layers, add)
    qos_resume = serve_tenants(torch, model, prompts, n_layers, add)
    return total, spy["resume_launches"] + qos_resume, (prompts, oneshot)


# -- phase 9d -----------------------------------------------------------------

# the fixture phase: the committed trained fixture (data/fixtures/llama_k128,
# built by scripts/make_torch_fixture.py: 2 layers, hidden 256, GQA group 2
# on one KV head at head_dim 128, max_seq_len 2048, trained on data/vi_eval)
# through --weights-dir, its own byte-level BPE tokenizer read by
# text/bpe.py. At 128 new tokens the map prompts (1,194-1,482 tokens) take
# S = 2048 - 128 = 1920 (the bucket fallback), C = 2048; the reduce prompts
# (the template's 138 tokens and one map summary) S = 512. The spec path's
# caches are C = S + 137; the slot loop's S = 1920, its joins B = 1-4; a warm
# map batch resumes at K = 1792 (S less a row's uncovered last block, at
# most 64 tokens, floored to the 128-slot grid): Sq = 128 queries. Phase 3
# checks K1, K2 and K3 at each (FIXTURE_SHAPES: the batches' pads, an
# all-pad filler row last), and the phase fails on a batch outside them
FIXTURE_DIR = ROOT / "data" / "fixtures" / "llama_k128"
FIXTURE_NAME = "llama_k128"
FIXTURE_NEW, FIXTURE_SPEC_K = 128, 8
FIXTURE_KV, FIXTURE_G = 1, 2
FIXTURE_SHAPES = {1920: [0, 37, 450, 520, 650, 700, 726, 1920],
                  512: [0, 5, 60, 128, 200, 240, 250, 512]}
FIXTURE_RESUME_K = 1792
FIXTURE_JOIN_BATCHES = (1, 2, 4)
FIXTURE_CACHE_BLOCKS = 256
# the margin rule's recompute of a reference's logits: one row of a map
# prompt (1,195-1,483 tokens with BOS) and up to 127 generated tokens,
# left-padded to a multiple of 128 slots
FIXTURE_MARGIN_S = (1280, 1408, 1536, 1664)
# the fixture's int8 matmuls (weights [N, K]) and its two grouped launches
FIXTURE_GEMV_SHAPES = {"wo": (256, 256), "w_down": (256, 512), "head": (384, 256)}
FIXTURE_GEMV_GROUPS = {"q/k/v": ((256, 128, 128), 256), "gate/up": ((512, 512), 256)}


def fixture_verify_cases() -> list:
    """K3's cases at the fixture's shape: (what, S, Sq, C, fills, pads).
    The spec step's map batch (S = 1920, Sq = 9, C = S + 137: 18 rows, the
    <4,1> layout): rows 2-3 put their queries on both sides of the 512-slot
    split boundary at 2048, row 4 is parked at e = max_new, row 5's pad
    hides every key from its queries 0-2, row 7 is the all-pad filler; its
    reduce batch (S = 512) the same kinds of rows; the slot segment (Sq = 1:
    2 rows, C = 2048): fills S + t_b, row 6 a free slot (pad = S), row 7
    parked at limit C."""
    new, k1 = FIXTURE_NEW, FIXTURE_SPEC_K + 1
    return [
        ("spec S=1920", 1920, k1, 1920 + new + k1,
         [1920, 1925, 2040, 2045, 1920 + new, 1990, 1920, 1931],
         [0, 37, 450, 520, 650, 1993, 726, 1920]),
        ("spec S=512", 512, k1, 512 + new + k1, [512, 517, 560, 600, 512 + new, 530, 512, 520],
         [0, 5, 60, 128, 200, 533, 250, 512]),
        ("slot segment", 1920, 1, 1920 + new,
         [1920, 1925, 1937, 1984, 2020, 2047, 1923, 1920 + new],
         [0, 37, 450, 520, 650, 700, 1920, 64]),
    ]


def trimmed_ids(backend, row) -> list:
    """A generated id row cut at its first EOS or pad, as ints."""
    from vnsum_tpu_torch.backend.base import trim_to_eos

    return trim_to_eos([int(t) for t in row], backend.tok.eos_id, backend.tok.pad_id,
                       tuple(backend.gen_cfg.eos_ids))


def generate_rows(backend, prompts: list, **kw) -> tuple[list, dict]:
    """``backend.generate(prompts, **kw)`` and its generated id rows by
    prompt index, each cut at its EOS. generate packs its groups (plain and
    speculative) through ``_pack_group`` and detokenizes their rows in
    group order: the two hooked on the instance line rows up with
    prompts."""
    groups, rows = [], []
    pack, detok = backend._pack_group, backend._detok

    def pack_spy(group, *args, **kwargs):
        groups.append(list(group))
        return pack(group, *args, **kwargs)

    backend._pack_group = pack_spy
    backend._detok = lambda ids, extra_eos=(): rows.append(ids) or detok(ids, extra_eos)
    try:
        texts = backend.generate(prompts, **kw)
    finally:
        del backend._pack_group, backend._detok
    order = [i for g in groups for i in g]
    if sorted(order) != list(range(len(prompts))) or len(rows) != len(prompts):
        raise AssertionError(f"{len(rows)} rows in groups {groups} for {len(prompts)} prompts")
    return texts, {i: trimmed_ids(backend, r) for i, r in zip(order, rows)}


def check_fixture_batches(label: str, batches) -> None:
    """Every (B, S) a fixture run prefilled at is one FIXTURE_SHAPES holds
    (B = 8), whose K1 and K2 phase 3 checked."""
    got = {tuple(b) for b in batches}
    if not got <= {(8, S) for S in FIXTURE_SHAPES}:
        raise AssertionError(f"{label}: batches {sorted(got)} outside phase 3's "
                             f"{sorted(FIXTURE_SHAPES)} at B=8")


def first_difference(a: list, b: list):
    """The first step at which two id rows differ (one ending before the
    other included); None if they are equal."""
    for t, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return t
    return None if len(a) == len(b) else min(len(a), len(b))


def reference_logits(torch, engine, ids: list):
    """The last-position logits of ``engine`` (a reference arm's backend)
    over one token row, through its own prefill arithmetic: K1 over its
    cache type (int8 or bf16) where it runs the kernels, the dense masked
    forward where it does not; the row left-padded to a multiple of 128
    slots, as the engine's buckets are. Touches no engine counter."""
    from vnsum_tpu_torch.backend.base import left_pad_batch
    from vnsum_tpu_torch.models.llama import (
        init_kv_cache,
        prefill_attention_mask,
        prefill_positions,
    )

    S = -(-len(ids) // 128) * 128
    if engine.use_kernels and S not in FIXTURE_MARGIN_S:
        raise AssertionError(f"the margin rule's K1 at S={S}, outside phase 3's "
                             f"{FIXTURE_MARGIN_S}")
    tokens_np, pads_np = left_pad_batch([ids], 1, S, engine.tok.pad_id)
    tokens = torch.from_numpy(tokens_np).to(engine.device)
    pads = torch.from_numpy(pads_np).to(engine.device)
    cache = init_kv_cache(engine.cfg, 1, S, quantized=engine.quantize_kv, device=engine.device)
    with torch.inference_mode():
        return engine.model(
            tokens, prefill_positions(pads, S), cache, 0,
            None if engine.use_kernels else prefill_attention_mask(pads, S, S), last_only=True,
            stacked_attention_fn=engine._prefill_stacked(pads, 0))[0, -1].float()


def margin_rule(torch, label: str, ref_engine, prompts: list, texts: list, ref_texts: list,
                rows: dict, ref_rows: dict, limit: float | None) -> None:
    """The margin rule (FIXTURE_MARGIN_RTOL) for one arm against its
    reference arm, run on ``ref_engine``: agreement logged; each row whose
    ids differ from the reference's logs its first differing step t and the
    reference's top-1 - top-2 logit margin at t over its largest |logit|
    (``reference_logits`` over the prompt and the reference's first t ids;
    "top-1 moved" where that forward's top-1 is not the reference's token).
    With a ``limit``, a margin above it raises."""
    tok = ref_engine.tok
    encoded = tok.encode_batch(prompts, add_bos=True)
    found, over = [], []
    for i in sorted(ref_rows):
        t = first_difference(rows[i], ref_rows[i])
        if t is None:
            continue
        logits = reference_logits(torch, ref_engine, encoded[i] + ref_rows[i][:t])
        top = logits.topk(2)
        margin = float(top.values[0] - top.values[1]) / float(logits.abs().max())
        want = ref_rows[i][t] if t < len(ref_rows[i]) else tok.eos_id
        found.append(f"row {i}: step {t}, margin {margin:.3e}"
                     + ("" if int(top.indices[0]) == want else " (top-1 moved)"))
        if limit is not None and margin > limit:
            over.append(found[-1])
    log(f"[fixture] {label}: {agreement(texts, ref_texts)}; rows whose ids differ "
        f"{len(found)}/{len(ref_rows)}" + (": " + "; ".join(found) if found else "")
        + (f"; margin limit {limit:g}" if limit is not None else "; not gated"))
    if over:
        raise AssertionError(f"fixture {label}: a first difference at a margin above "
                             f"{limit:g}, more than rounding can flip: {over}")


def fixture_prompts(backend) -> tuple[list, list]:
    """The map batch's prompts and their chunks (each one's speculation
    reference), as the pipeline builds them on ``backend``'s tokenizer."""
    from vnsum_tpu_torch.core.config import PipelineConfig
    from vnsum_tpu_torch.strategies import get_strategy

    docs = sorted((ROOT / "data/vi_eval/doc").glob("*.txt"))
    cfg = PipelineConfig(approach="mapreduce", models=[FIXTURE_NAME],
                         max_new_tokens=FIXTURE_NEW)
    strategy = get_strategy("mapreduce", backend, cfg)
    chunks = [c for d in docs for c in strategy.splitter.split_text(d.read_text(encoding="utf-8"))]
    return [strategy.map_prompt.format(content=c) for c in chunks], chunks


def fixture_pipeline(torch, tok) -> tuple[dict, dict]:
    """(a) the CLI's map-reduce over data/vi_eval with --weights-dir on the
    fixture (its own tokenizer), 128 new tokens, int8 cache, decode steps
    captured: every document ok, K1 = n_layers x prefill forwards and K2 =
    n_layers x decode steps exactly; logs ROUGE-1/2/L against the
    references, the rows that stop at EOS and the mean output tokens.
    Returns (launches, summaries)."""
    from vnsum_tpu_torch.backend.base import trim_to_eos
    from vnsum_tpu_torch.pipeline import cli

    docs = sorted((ROOT / "data/vi_eval/doc").glob("*.txt"))
    n_layers = json.loads((FIXTURE_DIR / "config.json").read_text())["num_hidden_layers"]
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        reset_launches()
        t0 = time.perf_counter()
        with recorded_rows() as rows:
            rc = cli.main([
                "--approach", "mapreduce", "--models", FIXTURE_NAME,
                "--weights-dir", str(FIXTURE_DIR),
                "--docs-dir", str(ROOT / "data/vi_eval/doc"),
                "--summary-dir", str(ROOT / "data/vi_eval/summary"),
                "--generated-summaries-dir", str(out / "gen"),
                "--results-dir", str(out / "results"), "--logs-dir", str(out / "logs"),
                "--max-new-tokens", str(FIXTURE_NEW), "--device", "cuda",
            ])
        wall = time.perf_counter() - t0
        launches = read_launches()
        if rc != 0:
            raise AssertionError(f"fixture CLI exited {rc}")
        res = json.loads(next((out / "results").glob("pipeline_results_*.json")).read_text())
        rec, summaries = check_run(res["results"], docs, out / "gen", model=FIXTURE_NAME)
    if res["config"]["weights_dir"] != str(FIXTURE_DIR):
        raise AssertionError(f"fixture CLI: run record {res['config']}")
    eng = res["results"]["engine"][FIXTURE_NAME]
    check_captured("fixture pipeline", eng)
    check_fixture_batches("fixture pipeline", (
        tuple(int(part.split("=")[1]) for part in b.split(",")) for b in eng["by_bucket"]))
    check_exact("fixture pipeline", launches, {
        "prefill": n_layers * eng["prefill_forwards"],
        "decode": n_layers * eng["decode_steps"]}, ("prefill", "decode"))
    cut = [trim_to_eos(r, tok.eos_id, tok.pad_id) for r in rows]
    stopped = sum(len(c) < len(r) and r[len(c)] == tok.eos_id for c, r in zip(cut, rows))
    rouge = res["results"]["evaluation"][FIXTURE_NAME]["rouge_scores"]
    log(f"[fixture] pipeline (CLI, --weights-dir {FIXTURE_DIR.relative_to(ROOT)}, "
        f"{type(tok).__name__} {tok.vocab_size} tokens): {rec['successful']}/{len(docs)} docs "
        f"ok, chunks {rec['total_chunks']}, wall {wall:.2f}s, batches {eng['by_bucket']}, "
        f"prefill {eng['phase_seconds'].get('prefill', 0.0):.3f}s, decode "
        f"{eng['phase_seconds'].get('decode', 0.0):.3f}s ({eng['decode_steps']} steps, "
        f"{eng['captured_steps']} replays); rows that stop at EOS {stopped}/{len(rows)}, mean "
        f"output tokens {sum(map(len, cut)) / len(cut):.1f} of {FIXTURE_NEW}")
    log(f"[fixture] rouge against data/vi_eval/summary (the fixture trained on them): "
        f"{json.dumps(rouge)}")
    return launches, summaries


# (b) the arms of scripts/make_quality_lossy_ab.py on the map prompts: the
# f32 dense oracle (no kernels), then bf16 weights through the kernels over
# a bf16 cache, over the int8 cache (the default), int8 weights
# (--quantize) and W8A8 prefill (--quantize --quantize-act)
FIXTURE_ARMS = (
    ("f32 dense (oracle)", "f32", {"flash": False}),
    ("bf16 kernels, bf16 cache", "bf16", {"quantize_kv": False}),
    ("int8 cache", "bf16", {}),
    ("--quantize", "bf16", {"quantize": True}),
    ("W8A8", "bf16", {"quantize": True, "quantize_act": True}),
)


def fixture_arms(torch, models: dict, spec: str, prompts: list) -> tuple[dict, dict]:
    """(b): each arm of FIXTURE_ARMS generates the map prompts (128 new
    tokens) on a backend of its own: launches exact (none for the oracle;
    K1, K2 and, with int8 weights, the GEMV as the engine record implies);
    each later arm's string agreement and ROUGE-L against the oracle, and
    its first differences' margins against it (logged, not gated:
    FIXTURE_MARGIN_RTOL). Returns (launches, {arm: (texts, rows, backend)})."""
    from vnsum_tpu_torch.backend.engine import TorchBackend
    from vnsum_tpu_torch.eval.rouge import RougeScorer

    scorer = RougeScorer(["rougeL"])
    total = dict.fromkeys(COUNTERS, 0)
    outs = {}
    for label, dtype, kw in FIXTURE_ARMS:
        model = models[dtype]
        b = TorchBackend(model=model, tokenizer=spec, batch_size=8, max_new_tokens=FIXTURE_NEW,
                         device="cuda", **kw)
        n_layers = b.cfg.n_layers
        reset_launches()
        t0 = time.perf_counter()
        texts, rows = generate_rows(b, prompts)
        wall = time.perf_counter() - t0
        launches = read_launches()
        st = b.stats
        if b.use_kernels:
            check_fixture_batches(f"fixture {label}", st.by_bucket)
            check_exact(f"fixture {label}", launches, {
                "prefill": n_layers * st.prefill_forwards, "decode": n_layers * st.decode_steps,
                "gemv": gemv_need(st.to_dict(), n_layers, b.cfg.w8a8_prefill)
                if b.model.quantized else 0}, ("prefill", "decode"))
        else:
            check_exact(f"fixture {label}", launches, {}, ())
        for k in total:
            total[k] += launches[k]
        outs[label] = (texts, rows, b)
        line = (f"[fixture] arm {label}: wall {wall:.2f}s, {st.decode_steps} decode steps, "
                f"mean output tokens {sum(map(len, rows.values())) / len(rows):.1f}")
        if label != FIXTURE_ARMS[0][0]:
            oracle = outs[FIXTURE_ARMS[0][0]][0]
            rl = [scorer.score(a, o)["rougeL"].fmeasure for a, o in zip(texts, oracle)]
            line += (f", string agreement with the oracle {sum(a == o for a, o in zip(texts, oracle))}"
                     f"/{len(texts)}, ROUGE-L against it {sum(rl) / len(rl):.4f}")
        log(line)
    oracle_texts, oracle_rows, oracle = outs[FIXTURE_ARMS[0][0]]
    for label, _, _ in FIXTURE_ARMS[1:]:
        margin_rule(torch, f"arm {label} against the oracle", oracle, prompts, outs[label][0],
                    oracle_texts, outs[label][1], oracle_rows, FIXTURE_MARGIN_RTOL["lossy"])
    return total, outs


def fixture_spec(torch, model, spec: str, prompts: list, chunks: list, oneshot: tuple,
                 plain_summaries: dict) -> dict:
    """(c): the reference-guided spec path through PipelineRunner (spec_k
    8: every map and reduce group with references decodes through K3),
    launches exact, drafts proposed and accepted, agreement with (a)'s
    summaries; then on the same backend the map prompts with their chunks
    as references, and the oracle (the one-shot rows decoded, unstripped,
    as references), which must accept drafts: each against the one-shot
    run ``oneshot`` (the int8-cache arm's texts, rows and backend) under
    the margin rule (FIXTURE_MARGIN_RTOL["spec"]). Returns the launches."""
    from vnsum_tpu_torch.backend.engine import TorchBackend
    from vnsum_tpu_torch.core.config import GenerationConfig, PipelineConfig
    from vnsum_tpu_torch.pipeline.runner import PipelineRunner

    docs = sorted((ROOT / "data/vi_eval/doc").glob("*.txt"))
    backends = []

    def factory(_):
        backends.append(TorchBackend(
            model=model, tokenizer=spec, generation=GenerationConfig(spec_k=FIXTURE_SPEC_K),
            max_new_tokens=FIXTURE_NEW, batch_size=8, device="cuda"))
        return backends[-1]

    with tempfile.TemporaryDirectory() as tmp:
        cfg = PipelineConfig(
            approach="mapreduce", models=[FIXTURE_NAME], max_new_tokens=FIXTURE_NEW,
            docs_dir=str(ROOT / "data/vi_eval/doc"),
            summary_dir=str(ROOT / "data/vi_eval/summary"),
            generated_summaries_dir=str(Path(tmp) / "gen"),
            results_dir=str(Path(tmp) / "results"), logs_dir=str(Path(tmp) / "logs"))
        reset_launches()
        t0 = time.perf_counter()
        runner = PipelineRunner(cfg, backend_factory=factory, device="cuda")
        res = runner.run()
        wall = time.perf_counter() - t0
        launches = read_launches()
        if runner.failures:
            raise AssertionError(f"fixture spec pipeline failures: {runner.failures}")
        _, summaries = check_run({"summarization": res.summarization,
                                  "evaluation": res.evaluation},
                                 docs, Path(tmp) / "gen", model=FIXTURE_NAME)
    b = backends[0]
    st, n_layers = b.stats, b.cfg.n_layers
    if st.spec_verify_steps == 0:
        raise AssertionError("fixture spec pipeline: no verify step ran")
    check_fixture_batches("fixture spec pipeline", st.by_bucket)
    check_exact("fixture spec pipeline", launches, {
        "prefill": n_layers * st.prefill_forwards, "verify": n_layers * st.spec_verify_steps,
        "decode": n_layers * st.decode_steps})
    names = sorted(plain_summaries)
    log(f"[fixture] spec pipeline: wall {wall:.2f}s, {st.spec_verify_steps} verify steps "
        f"({1e3 * st.phase_seconds.get('spec_decode', 0.0) / st.spec_verify_steps:.1f} ms a "
        f"step), drafted {st.spec_draft_tokens}, accepted {st.spec_accepted_tokens}, one-shot "
        f"decode steps {st.decode_steps}; against (a)'s summaries: "
        f"{agreement([summaries[n] for n in names], [plain_summaries[n] for n in names])}; "
        f"rouge {json.dumps(res.evaluation[FIXTURE_NAME]['rouge_scores'])}")
    total = dict(launches)
    base_texts, base_rows, base = oneshot
    oracle_refs = [b.tok.decode(base_rows[i]) for i in range(len(prompts))]
    for run, refs in (("chunks as references", chunks), ("oracle", oracle_refs)):
        reset_launches()
        forwards0, decode0 = st.prefill_forwards, st.decode_steps
        steps0, drafted0, acc0 = st.spec_verify_steps, st.spec_draft_tokens, st.spec_accepted_tokens
        texts, rows = generate_rows(b, prompts, references=refs)
        launches = read_launches()
        steps = st.spec_verify_steps - steps0
        accepted = st.spec_accepted_tokens - acc0
        check_exact(f"fixture spec {run}", launches, {
            "prefill": n_layers * (st.prefill_forwards - forwards0),
            "verify": n_layers * steps, "decode": n_layers * (st.decode_steps - decode0)})
        if run == "oracle" and accepted <= 0:
            raise AssertionError("fixture spec oracle: no draft accepted")
        log(f"[fixture] spec {run}: {steps} verify steps, drafted "
            f"{st.spec_draft_tokens - drafted0}, accepted {accepted}")
        margin_rule(torch, f"spec {run} against the one-shot run", base, prompts, texts,
                    base_texts, rows, base_rows, FIXTURE_MARGIN_RTOL["spec"])
        for k in total:
            total[k] += launches[k]
    return total


def fixture_resume(torch, model, spec: str, prompts: list, oneshot: tuple) -> dict:
    """(e): the map prompts through a fresh FIXTURE_CACHE_BLOCKS-block
    prefix cache, cold then warm (cache_arm: launches exact, counters
    consistent): every warm group resumes at FIXTURE_RESUME_K, the prompt
    tokens it skips logged; the warm call against the cold one under the
    margin rule (FIXTURE_MARGIN_RTOL["resume"]), both against the uncached
    one-shot run logged. Returns the launches."""
    from vnsum_tpu_torch.backend.engine import TorchBackend

    b = TorchBackend(model=model, tokenizer=spec, batch_size=8, max_new_tokens=FIXTURE_NEW,
                     cache_blocks=FIXTURE_CACHE_BLOCKS, cache_block_tokens=64, device="cuda")
    spy = spy_cache(torch, b)
    rows = {"cold": {}, "warm": {}}
    arms = {run: cache_arm(torch, b, f"fixture {run}", prompts, None, spy, rows[run])
            for run in ("cold", "warm")}
    check_fixture_batches("fixture prefix cache", b.stats.by_bucket)
    warm = arms["warm"]
    if warm["d"]["cache_hit_tokens"] <= 0 or set(warm["K"]) != {FIXTURE_RESUME_K}:
        raise AssertionError(f"fixture warm call: hit tokens {warm['d']['cache_hit_tokens']}, "
                             f"K by group {warm['K']} (phase 3 checked K1 at "
                             f"q_offset {FIXTURE_RESUME_K})")
    log(f"[fixture] warm resume: K {warm['K']}, prompt tokens skipped "
        f"{warm['d']['cache_hit_tokens']} of {warm['d']['prompt_tokens']}; cold against the "
        f"uncached one-shot run: {agreement(arms['cold']['texts'], oneshot[0])}")
    margin_rule(torch, "warm resume against the cold call", b, prompts, warm["texts"],
                arms["cold"]["texts"], rows["warm"], rows["cold"], FIXTURE_MARGIN_RTOL["resume"])
    return {k: arms["cold"]["launches"][k] + warm["launches"][k] for k in COUNTERS}


def fixture_preempt(torch, model, spec: str, prompts: list, oneshot: tuple) -> dict:
    """(f): tier preemption on the fixture. InflightScheduler (8 slots, S =
    1920, QOS_SEGMENT_TOKENS-step segments, a FIXTURE_CACHE_BLOCKS-block
    prefix cache, QOS_TENANTS) fed 8 batch-tier rows (the 7 map prompts and
    the first again, each behind its QOS_TAG), which fill the 8 slots in
    cold joins of 1, 2 or 4; then two interactive rows, cold, which evict
    batch rows at the next boundary. Every evictee re-joins warm at
    FIXTURE_RESUME_K (K1 at that q_offset, B = 1 or 2), its text held to
    the one-shot run of the same 8 prompts on the int8-cache arm's backend
    under the margin rule (FIXTURE_MARGIN_RTOL["preempt"]); launches
    exact. Returns the launches."""
    from vnsum_tpu_torch.backend.engine import TorchBackend
    from vnsum_tpu_torch.serve import InflightScheduler, TenantTable, parse_tenant_specs

    n_layers = model.cfg.n_layers
    rows = [QOS_TAG.format(n) + p for n, p in enumerate(prompts + prompts[:1])]
    ref_texts, ref_rows = generate_rows(oneshot[2], rows)
    b = TorchBackend(model=model, tokenizer=spec, batch_size=8, max_new_tokens=FIXTURE_NEW,
                     segment_tokens=QOS_SEGMENT_TOKENS, cache_blocks=FIXTURE_CACHE_BLOCKS,
                     cache_block_tokens=64, device="cuda")
    loops = spy_loops(b)
    spy = spy_cache(torch, b)
    admissions = spy_admissions(b)
    # a step detokenizes its completions in their order: the id rows by rid
    detokenized, ids = [], {}
    detok = b._detok
    b._detok = lambda row, extra_eos=(): detokenized.append(row) or detok(row, extra_eos)
    start = b.start_slot_loop

    def start_spy(*args, **kw):
        loop = start(*args, **kw)
        step = loop.step

        def step_spy():
            n0 = len(detokenized)
            res = step()
            for j, c in enumerate(res.completions):
                ids[c.key.trace_id] = trimmed_ids(b, detokenized[n0 + j])
            return res

        loop.step = step_spy
        return loop

    b.start_slot_loop = start_spy
    docs = sorted((ROOT / "data/vi_eval/doc").glob("*.txt"))
    ui = ["Trả lời ngắn gọn: " + d.read_text(encoding="utf-8")[:600] for d in docs[:2]]
    sched = InflightScheduler(b, slots=len(rows), slot_prompt_tokens=max(FIXTURE_SHAPES),
                              max_wait_s=SERVE_WAIT_S,
                              tenants=TenantTable(parse_tenant_specs(QOS_TENANTS)))
    evictees = []
    requeue = sched._requeue_eviction

    def spy_requeue(ev):
        evictees.append(ev.key.trace_id)
        requeue(ev)

    sched._requeue_eviction = spy_requeue
    try:
        reset_launches()
        forwards0 = b.stats.prefill_forwards
        t0 = time.perf_counter()
        futs = {f"fx-bulk-{n}": sched.submit(p, max_new_tokens=FIXTURE_NEW, tenant="bulk",
                                             tier="batch", trace_id=f"fx-bulk-{n}")
                for n, p in enumerate(rows)}
        t_end = time.perf_counter() + 300
        while sched.slot_state()[1] < len(rows):
            if time.perf_counter() > t_end:
                raise AssertionError(f"fixture preemption: slots {sched.slot_state()}")
            time.sleep(0.001)
        ui_futs = [sched.submit(q, max_new_tokens=FIXTURE_NEW, tenant="ui", trace_id=f"fx-ui-{j}")
                   for j, q in enumerate(ui)]
        done = {rid: f.result(timeout=600) for rid, f in futs.items()}
        ui_done = [f.result(timeout=600) for f in ui_futs]
        wall = time.perf_counter() - t0
        launches = read_launches()
        snap = sched.metrics.snapshot()
    finally:
        sched.close()
    rejoins = [(rid, cached) for rid, cached in admissions if rid in evictees]
    resumed_K = sorted({K for K in spy["K"] if K})
    joins = sorted(b.stats.by_bucket)
    if (not evictees or len(set(evictees)) != len(evictees) or snap.preemptions != len(evictees)
            or any(c.record.status != "ok" for c in [*done.values(), *ui_done])
            or len(rejoins) != 2 * len(evictees)
            or not all(cached > 0 for _, cached in rejoins[len(evictees):])
            or resumed_K != [FIXTURE_RESUME_K]
            or not {B for B, _ in joins} <= {8, *FIXTURE_JOIN_BATCHES}
            or {S for _, S in joins} != {max(FIXTURE_SHAPES)}):
        raise AssertionError(f"fixture preemption: evictees {evictees}, preemptions "
                             f"{snap.preemptions}, evictee admissions {rejoins}, resumed K "
                             f"{resumed_K}, join batches {joins}")
    check_exact("fixture tier preemption", launches, {
        "prefill": n_layers * (b.stats.prefill_forwards - forwards0),
        "verify": n_layers * sum(loop.decode_steps for loop in loops)})
    log(f"[fixture] tier preemption: {len(evictees)} evicted ({evictees}), re-joined warm "
        f"{rejoins[len(evictees):]} at K {resumed_K}, join batches {joins}, "
        f"{snap.segments} segments, wall {wall:.2f}s")
    ev_rows = [int(rid.rsplit("-", 1)[1]) for rid in evictees]
    margin_rule(torch, "preemption evictees against the one-shot run", oneshot[2],
                [rows[n] for n in ev_rows], [done[rid].text for rid in evictees],
                [ref_texts[n] for n in ev_rows], {k: ids[rid] for k, rid in enumerate(evictees)},
                {k: ref_rows[n] for k, n in enumerate(ev_rows)}, FIXTURE_MARGIN_RTOL["preempt"])
    return launches


def phase_fixture(torch) -> dict:
    """Phase 9d: the committed trained fixture with its own tokenizer
    (text/bpe.py, no transformers), every one-card path through K1, K2 and
    K3 at its shape: (a) the CLI's map-reduce with --weights-dir, (b) the
    lossy arms against the f32 oracle, (c) the spec path, (d) the slot loop,
    (e) a warm prefix-cache resume; the margin rule on every arm against
    its reference. Returns the phase's launches."""
    from vnsum_tpu_torch.backend.engine import TorchBackend
    from vnsum_tpu_torch.models.convert import load_hf_checkpoint
    from vnsum_tpu_torch.text.bpe import BPETokenizer
    from vnsum_tpu_torch.text.tokenizer import get_tokenizer

    spec = f"hf:{FIXTURE_DIR}"
    tok = get_tokenizer(spec)
    if not isinstance(tok, BPETokenizer):
        raise AssertionError(f"{spec} loads {type(tok).__name__}, not the BPE reader")
    total = dict.fromkeys(COUNTERS, 0)

    def add(launches):
        for k in total:
            total[k] += launches[k]

    launches, summaries = fixture_pipeline(torch, tok)
    add(launches)
    models = {"bf16": load_hf_checkpoint(str(FIXTURE_DIR), device="cuda")[1],
              "f32": load_hf_checkpoint(str(FIXTURE_DIR), dtype=torch.float32,
                                        device="cuda")[1]}
    if (models["bf16"].cfg.n_heads, models["bf16"].cfg.n_kv_heads,
            models["bf16"].cfg.head_dim) != (FIXTURE_KV * FIXTURE_G, FIXTURE_KV, 128):
        raise AssertionError(f"fixture config {models['bf16'].cfg}")
    prompts, chunks = fixture_prompts(TorchBackend(model=models["bf16"], tokenizer=spec,
                                                   max_new_tokens=FIXTURE_NEW, device="cuda"))
    lengths = tok.count_batch(prompts)
    log(f"[fixture] map prompts: {len(prompts)}, {min(lengths)}-{max(lengths)} tokens "
        f"(trained on 64-token windows: later positions extrapolate)")
    launches, outs = fixture_arms(torch, models, spec, prompts)
    add(launches)
    oneshot = outs["int8 cache"]
    add(fixture_spec(torch, models["bf16"], spec, prompts, chunks, oneshot, summaries))
    slot_rows: dict = {}
    add(slot_loop(torch, models["bf16"], prompts, oneshot[0], "fixture slot", FIXTURE_NEW, (4,),
                  prompt_tokens=max(FIXTURE_SHAPES), tokenizer=spec, rows=slot_rows))
    margin_rule(torch, "slot loop against the one-shot run", oneshot[2], prompts,
                [tok.decode(slot_rows[4][i]).strip() for i in range(len(prompts))],
                oneshot[0], slot_rows[4], oneshot[1], FIXTURE_MARGIN_RTOL["slot"])
    add(fixture_resume(torch, models["bf16"], spec, prompts, oneshot))
    add(fixture_preempt(torch, models["bf16"], spec, prompts, oneshot))
    log("[launches] fixture phase: " + ", ".join(f"{k} {v}" for k, v in total.items()))
    del models, outs, oneshot
    torch.cuda.empty_cache()
    return total


# -- phase 9e -----------------------------------------------------------------

# the replica fleet (ROADMAP A15b-3): the port's router (serve/router.py) in
# front of worker processes (serve/worker.py) that run the port's engine on
# this card. Fleet A: `python -m vnsum_tpu_torch.serve.router --spawn-workers
# 2 --backend torch`, two micro-batch workers of Llama-3.2-3B at full width
# and depth drawn from seed 0 (the spec phase's weights, so phase 9c's
# direct generate is their reference), no prefix cache (9c's control has
# none), a coalescing window of FLEET_WAIT_MS (one fan-out request's 7
# prompts are one engine batch). Fleet B: a RouterState in this process over
# two build_fleet handles of the trained fixture with --inflight --slots 8
# (its greedy tokens have no near-ties across batch shapes: phase 9d), S = 1920
# as phase 9d's slot loop. The workers' kernel launches are counted in their
# own processes, which this process's counters cannot see.
FLEET_WAIT_MS = 250
# a worker's start-up budget here (import torch, a CUDA context, 3.2 B
# weights drawn on the card, the libraries loaded); the router's and the
# handles' own defaults (30 s and 60 s, the JAX package's) stay as they are
FLEET_READY_S = 180.0
FLEET_MODEL, FLEET_DEVICE = "llama3.2:3b", "cuda"
FLEET_SINGLES = 8
FLEET_RESTART_EVERY_S = 0.1


def fleet_env() -> dict:
    """The environment of every process the phase starts: this checkout's
    package first on the path."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    return env


def gpu_apps() -> dict:
    """{pid: MiB} of the card's compute apps as nvidia-smi lists them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout
    apps = {}
    for line in out.splitlines():
        parts = [x.strip() for x in line.split(",")]
        if len(parts) == 2 and parts[0].isdigit():
            apps[int(parts[0])] = float(parts[1].split()[0]) if parts[1][:1].isdigit() else 0.0
    return apps


def proc_alive(pid: int) -> bool:
    """Whether ``pid`` runs (a zombie holds nothing and counts as gone)."""
    try:
        stat = Path(f"/proc/{pid}/stat").read_text()
    except OSError:
        return False
    return stat.rsplit(")", 1)[1].split()[0] != "Z"


def stop_pids(pids) -> None:
    """SIGTERM every pid still running, then SIGKILL what is left 30 s on."""
    import signal

    live = [p for p in pids if proc_alive(p)]
    for pid in live:
        with contextlib.suppress(OSError):
            os.kill(pid, signal.SIGTERM)
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline and any(proc_alive(p) for p in live):
        time.sleep(0.1)
    for pid in live:
        if proc_alive(pid):
            with contextlib.suppress(OSError):
                os.kill(pid, signal.SIGKILL)
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline and any(proc_alive(p) for p in live):
        time.sleep(0.1)


def rendezvous(key: str, names) -> str:
    """The worker the router's rendezvous hash ranks first for ``key``
    (serve/router.py ``_pick_locked``: the largest crc32 of key|name)."""
    import zlib

    return max(names, key=lambda n: zlib.crc32(f"{key}|{n}".encode()))


def hints_for(names, per_worker: int, prefix: str) -> list:
    """(hint, worker) pairs, ``per_worker`` for each worker, in turn."""
    by = {n: [] for n in names}
    i = 0
    while any(len(v) < per_worker for v in by.values()):
        hint = f"{prefix}-{i}"
        w = rendezvous(hint, names)
        if len(by[w]) < per_worker:
            by[w].append(hint)
        i += 1
    return [(by[n][j], n) for j in range(per_worker) for n in names]


def library_mtimes() -> dict:
    from vnsum_tpu_torch.ops import kernels

    return {p.name: p.stat().st_mtime_ns for p in kernels.BUILD_DIR.glob("*.so")}


def worker_rows(base: str) -> dict:
    status, health = serve_request("GET", base + "/healthz", timeout=30)
    if status != 200:
        raise AssertionError(f"fleet: router /healthz {status}: {health}")
    return {w["name"]: w for w in health["workers"]}


def wait_fleet_up(base: str, names, started: set, t0: float, alive) -> dict:
    """Seconds from ``t0`` until each worker is up on the router's
    /healthz; every worker pid seen joins ``started``. A worker that exits
    before it is up (a respawn, or a reason ``exit:*``) fails the phase, as
    does the router's own exit (``alive()`` false)."""
    up: dict = {}
    deadline = time.monotonic() + FLEET_READY_S
    while len(up) < len(names):
        if not alive():
            raise AssertionError("fleet: the router exited while its workers started")
        try:
            rows = worker_rows(base)
        except OSError:
            rows = {}
        for name, row in rows.items():
            if row.get("pid"):
                started.add(row["pid"])
            if name not in up and (row["restarts"] or str(row["reason"]).startswith("exit:")):
                raise AssertionError(f"fleet: {name} exited at start-up ({row['reason']}, "
                                     f"{row['restarts']} restart(s))")
            if name not in up and row["up"]:
                up[name] = time.perf_counter() - t0
        if time.monotonic() > deadline:
            raise AssertionError(f"fleet: workers up {sorted(up)} of {names} after "
                                 f"{FLEET_READY_S:.0f}s")
        time.sleep(0.1)
    return up


def worker_startup_trace(argv: list) -> str:
    """The last lines a worker with ``argv`` prints when run by hand (the
    router's workers write nowhere), for a start-up failure's report."""
    from vnsum_tpu_torch.testing.chaos import free_port

    cmd = [sys.executable, "-m", "vnsum_tpu_torch.serve.worker", "--port", str(free_port()),
           *argv]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            env=fleet_env(), cwd=ROOT)
    try:
        out, _ = proc.communicate(timeout=FLEET_READY_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
    return "\n".join(out.splitlines()[-40:])


def fleet_memory(torch, pids: list, free0: int, apps0: dict, weight_bytes: int) -> str:
    """The workers' memory on the card: nvidia-smi's compute apps (by pid
    where this process sees the card's pid namespace; a sandbox may list
    all its processes as one pid, so else their total's rise since the
    fleet started) and the card's free memory against ``free0``. Each must
    show every worker holding its weights."""
    apps = gpu_apps()
    rise = free0 - torch.cuda.mem_get_info()[0]
    mine = {pid: apps[pid] for pid in pids if pid in apps}
    listed = (sum(apps.values()) - sum(apps0.values())) * 2**20
    need = len(pids) * weight_bytes
    if len(mine) == len(pids):
        ok = all(mib * 2**20 >= weight_bytes for mib in mine.values())
        how = "by pid: " + ", ".join(f"{pid} {mib:.0f} MiB" for pid, mib in sorted(mine.items()))
    else:
        ok = listed >= need
        how = (f"as {sorted(apps)} (not the workers' pids {pids}: another pid namespace), "
               f"{listed / 2**20:.0f} MiB more than before the fleet")
    if not ok or rise < need:
        raise AssertionError(f"fleet: compute apps {apps} (before {apps0}), worker pids {pids}, "
                             f"free memory fell {rise / 1e9:.2f} GB, weights {need / 1e9:.2f} GB")
    return (f"nvidia-smi lists the compute apps {how}; the card's free memory fell "
            f"{rise / 1e9:.2f} GB ({rise / len(pids) / 1e9:.2f} GB a worker; weights "
            f"{weight_bytes / 0.9 / 1e9:.2f} GB each)")


def fleet_a(torch, serve_ref: tuple, started: set) -> None:
    """Fleet A through the router's CLI, at Llama-3.2-3B's full width and
    depth: (h1) routing, (h4) federation, then a graceful stop."""
    import signal

    from vnsum_tpu_torch.models import MODEL_REGISTRY, llama32_3b
    from vnsum_tpu_torch.serve.federation import fold_incident_bundle
    from vnsum_tpu_torch.serve.journal import RequestJournal
    from vnsum_tpu_torch.testing.chaos import RouterProcess, free_port

    prompts, oneshot = serve_ref
    cfg = MODEL_REGISTRY[FLEET_MODEL]()
    if FLEET_MODEL == "llama3.2:3b" and cfg != llama32_3b():
        raise AssertionError(f"fleet: the registry's {FLEET_MODEL} is not the spec phase's config")
    weight_bytes = int(0.9 * 2 * (cfg.vocab_size * cfg.dim * (1 if cfg.tie_embeddings else 2)
                                  + cfg.n_layers * cfg.dim * (
                                      (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim
                                      + cfg.n_heads * cfg.head_dim + 3 * cfg.intermediate)))
    worker_args = [
        "--model", FLEET_MODEL, "--device", FLEET_DEVICE, "--seed", "0",
        "--max-new-tokens", str(SERVE_NEW), "--max-batch", "8",
        "--max-wait-ms", str(FLEET_WAIT_MS), "--no-prefix-cache"]
    names = ["worker-0", "worker-1"]
    gc.collect()
    torch.cuda.empty_cache()
    free0, apps0 = torch.cuda.mem_get_info()[0], gpu_apps()
    with tempfile.TemporaryDirectory() as tmp:
        fleet_dir = Path(tmp) / "fleet"
        port = free_port()
        base = f"http://127.0.0.1:{port}"
        rp = RouterProcess(port, fleet_dir=str(fleet_dir), spawn_workers=len(names),
                           extra_args=["--backend", "torch", "--worker-args",
                                       " ".join(worker_args)], env=fleet_env())
        t0 = time.perf_counter()
        rp.start()
        started.add(rp.proc.pid)
        try:
            try:
                up = wait_fleet_up(base, names, started, t0, lambda: rp.alive)
            except AssertionError:
                log("[fleet] A: a worker run by hand with the same flags prints:\n"
                    + worker_startup_trace(["--backend", "torch", *worker_args]))
                raise
            rows = worker_rows(base)
            pids = [rows[n]["pid"] for n in names]
            log(f"[fleet] A up: router :{port} over {names} (pids {pids}), --backend torch "
                f"{' '.join(worker_args)}; up after "
                + ", ".join(f"{n} {up[n]:.1f}s" for n in names)
                + "; " + fleet_memory(torch, pids, free0, apps0, weight_bytes))

            # (h1) routing: the 7 map prompts as one request, byte for byte
            # phase 9c's direct generate
            t1 = time.perf_counter()
            status, body = serve_request("POST", base + "/v1/generate", {
                "prompts": prompts, "max_new_tokens": SERVE_NEW, "request_id": "fleet-batch"})
            batch_s = time.perf_counter() - t1
            if status != 200:
                raise AssertionError(f"fleet (h1): batch HTTP {status}: {body}")
            texts = [c["text"] for c in body["completions"]]
            if texts != oneshot:
                raise AssertionError(f"fleet (h1): texts differ from phase 9c's direct "
                                     f"generate: {agreement(texts, oneshot)}")
            # singles pinned by cache_hint, FLEET_SINGLES // 2 a worker: each
            # on the worker the rendezvous ranking names
            pinned = hints_for(names, FLEET_SINGLES // 2, "fleet")
            before = {n: r["requests"] for n, r in worker_rows(base).items()}
            single_s, single_texts = [], []
            for i, (hint, _want) in enumerate(pinned):
                t1 = time.perf_counter()
                status, body = serve_request("POST", base + "/v1/generate", {
                    "prompt": prompts[i % len(prompts)], "max_new_tokens": SERVE_NEW,
                    "cache_hint": hint, "request_id": f"fleet-single-{i}"})
                single_s.append(time.perf_counter() - t1)
                if status != 200:
                    raise AssertionError(f"fleet (h1): single {i} HTTP {status}: {body}")
                single_texts.append(body["completions"][0]["text"])
            _, ring = serve_request("GET", base + "/debug/flightrecorder")
            routed = {e["rid"]: e["worker"] for e in ring["events"] if e["kind"] == "route"}
            went = [routed.get(f"fleet-single-{i}") for i in range(len(pinned))]
            if went != [w for _h, w in pinned]:
                raise AssertionError(f"fleet (h1): singles went to {went}, the rendezvous "
                                     f"ranking names {[w for _h, w in pinned]}")
            rows = worker_rows(base)
            served = {n: rows[n]["requests"] - before[n] for n in names}
            if served != {n: FLEET_SINGLES // 2 for n in names}:
                raise AssertionError(f"fleet (h1): /healthz requests by worker {served}")
            status, body = serve_request("POST", base + "/v1/generate",
                                         {"prompt": prompts[0], "stream": True})
            if status != 501 or body.get("error") != "stream_unsupported":
                raise AssertionError(f"fleet (h1): a stream answered {status}: {body}")
            log(f"[fleet] A (h1) routing: 7 map prompts in one request on "
                f"{routed.get('fleet-batch')}, byte-identical to phase 9c's direct generate, "
                f"{batch_s:.3f}s; {len(pinned)} singles on the workers the crc32 rendezvous "
                f"names ({served}), {min(single_s):.3f}-{max(single_s):.3f}s each, against the "
                f"batch {agreement(single_texts, [oneshot[i % len(oneshot)] for i in range(len(pinned))])} "
                f"(B = 1 against 8, not gated); a stream: typed 501")

            # (h4) federation: a fresh sweep (/debug/trace scrapes), then the
            # fleet rollup against each worker's own counters
            status, trace = serve_request("GET", base + "/debug/trace")
            procs: dict = {}
            for e in trace["traceEvents"]:
                if e.get("ph") == "M" and e.get("name") == "process_name":
                    procs[e["pid"]] = {"name": e["args"]["name"], "spans": []}
            for e in trace["traceEvents"]:
                if e.get("ph") == "X" and e["pid"] in procs:
                    procs[e["pid"]]["spans"].append(e)
            req = next((p for p in procs.values() if p["name"] == "request fleet-batch"), None)
            sources = {sp["args"].get("source") for sp in req["spans"]} if req else set()
            engine = sorted({sp["name"] for sp in req["spans"]
                             if sp["args"].get("source") in names}) if req else []
            if (status != 200 or "router" not in sources or not sources & set(names)
                    or not {"engine", "prefill"} & set(engine)):
                raise AssertionError(f"fleet (h4): /debug/trace {status}, fleet-batch's spans "
                                     f"from {sources}: {engine}")
            _, mtext = serve_request("GET", base + "/metrics")
            fleet_total = metric_value(mtext, "vnsum_serve_fleet_requests_total")
            per_worker = {}
            for n in names:
                _, wtext = serve_request("GET", f"http://{rows[n]['host']}:{rows[n]['port']}"
                                                "/metrics")
                per_worker[n] = {k: metric_value(wtext, f"vnsum_serve_{k}") for k in (
                    "requests_total", "batches_total", "generated_tokens_total")}
            if fleet_total != sum(v["requests_total"] for v in per_worker.values()):
                raise AssertionError(f"fleet (h4): vnsum_serve_fleet_requests_total "
                                     f"{fleet_total}, the workers' {per_worker}")
            incidents = fleet_dir / "incidents"
            before_inc = set(incidents.glob("inc_*")) if incidents.exists() else set()
            t1 = time.perf_counter()
            os.kill(rp.proc.pid, signal.SIGUSR1)
            bundle = None
            while time.perf_counter() - t1 < 60:
                new = set(incidents.glob("inc_*")) - before_inc if incidents.exists() else set()
                if new and all((b / "manifest.json").exists() for b in new):
                    bundle = sorted(new)
                    break
                time.sleep(0.05)
            if bundle is None or len(bundle) != 1:
                raise AssertionError(f"fleet (h4): SIGUSR1 wrote bundles {bundle}")
            manifest = json.loads((bundle[0] / "manifest.json").read_text())
            report = fold_incident_bundle(bundle[0])
            walls = [e["wall"] for e in report["events"]]
            if (manifest["reason"] != "operator" or manifest["workers_collected"] != 2
                    or set(report["sources"]) != {"router", *names}
                    or not all(report["sources"][s]["events"] for s in names)
                    or walls != sorted(walls)):
                raise AssertionError(f"fleet (h4): bundle {manifest}, sources "
                                     f"{report['sources']}")
            log(f"[fleet] A (h4) federation: vnsum_serve_fleet_requests_total {fleet_total:.0f} "
                f"= the workers' requests_total {[v['requests_total'] for v in per_worker.values()]}"
                f" (batches {[v['batches_total'] for v in per_worker.values()]}, generated "
                f"tokens {[v['generated_tokens_total'] for v in per_worker.values()]}); "
                f"/debug/trace stitches fleet-batch's spans from {sorted(sources)} (the "
                f"worker's {engine}); SIGUSR1: bundle {bundle[0].name} in "
                f"{time.perf_counter() - t1:.2f}s, {len(report['events'])} events folded from "
                + ", ".join(f"{k} {v['events']}" for k, v in sorted(report["sources"].items()))
                + ", in wall order; the workers' K1/K2 launches are counted in their own "
                  "processes, not this one's")
        finally:
            t1 = time.perf_counter()
            rp.sigterm()
            rc = rp.wait_exit(120)
            stop_s = time.perf_counter() - t1
        entries, sealed, _ = RequestJournal.read_state(fleet_dir / "router")
        left = [pid for pid in started if proc_alive(pid)]
        if rc != 0 or not sealed or any(not e.terminal for e in entries.values()) or left:
            raise AssertionError(f"fleet A stop: router rc {rc}, journal sealed {sealed}, "
                                 f"pids left {left}")
        log(f"[fleet] A stop: SIGTERM, router rc 0 in {stop_s:.2f}s, its journal sealed with "
            f"{len(entries)} entries all terminal, no worker left; wall "
            f"{time.perf_counter() - t0:.1f}s")


def fleet_b(torch, started: set) -> None:
    """Fleet B on the trained fixture, in flight: (h2) a SIGKILLed worker's
    accepted requests fail over byte-identically, (h3) a rolling restart
    answers every request."""
    import signal
    import threading

    from vnsum_tpu_torch.backend.engine import TorchBackend
    from vnsum_tpu_torch.models.convert import load_hf_checkpoint
    from vnsum_tpu_torch.serve.journal import RequestJournal, aggregate_status
    from vnsum_tpu_torch.serve.router import RouterState, Worker, make_router_server
    from vnsum_tpu_torch.serve.worker import build_fleet

    spec = f"hf:{FIXTURE_DIR}"
    model = load_hf_checkpoint(str(FIXTURE_DIR), device=FLEET_DEVICE)[1]
    prompts, _chunks = fixture_prompts(TorchBackend(model=model, tokenizer=spec,
                                                    max_new_tokens=FIXTURE_NEW,
                                                    device=FLEET_DEVICE))
    del model
    names = ["worker-0", "worker-1"]
    args = ["--backend", "torch", "--weights-dir", str(FIXTURE_DIR), "--device", FLEET_DEVICE,
            "--inflight", "--slots", "8", "--slot-prompt-tokens", str(max(FIXTURE_SHAPES)),
            "--max-new-tokens", str(FIXTURE_NEW), "--max-batch", "8", "--no-prefix-cache"]
    with tempfile.TemporaryDirectory() as tmp:
        handles = build_fleet(len(names), f"{tmp}/fleet", extra_args=args, env=fleet_env())
        spied: dict = {h.name: {"drains": [], "starts": []} for h in handles}
        for h in handles:
            def start(h=h, real=h.start):
                real()
                started.add(h.pid)
                spied[h.name]["starts"].append((time.perf_counter(), h.pid, h.generation))

            def drain(timeout_s=30.0, h=h, real=h.drain):
                t_drain = time.perf_counter()
                rc = real(timeout_s)
                sealed = RequestJournal.read_state(h.journal_dir)[1]
                spied[h.name]["drains"].append((t_drain, rc, sealed, h.generation))
                return rc

            h.start, h.drain = start, drain
        workers = [Worker(h.name, h.host, h.port, handle=h) for h in handles]
        state = RouterState(workers, journal_dir=f"{tmp}/fleet/router",
                            incident_dir=f"{tmp}/fleet/incidents")
        server = make_router_server(state, "127.0.0.1", 0)
        serve_thread = threading.Thread(target=server.serve_forever, daemon=True)
        base = f"http://127.0.0.1:{server.server_address[1]}"
        t0 = time.perf_counter()
        try:
            for h in handles:
                h.start()
            state.start()
            serve_thread.start()
            up = wait_fleet_up(base, names, started, t0, lambda: True)
            log(f"[fleet] B up: RouterState over build_fleet({len(names)}) of "
                f"{FIXTURE_DIR.name}, {' '.join(args[2:])}; up after "
                + ", ".join(f"{n} {up[n]:.1f}s" for n in names))

            def run(tag: str, hint) -> tuple:
                replies: dict = {}

                def post(i):
                    payload = {"prompt": prompts[i], "max_new_tokens": FIXTURE_NEW,
                               "request_id": f"{tag}-{i}"}
                    if hint:
                        payload["cache_hint"] = hint
                    replies[i] = serve_request("POST", base + "/v1/generate", payload)

                threads = [threading.Thread(target=post, args=(i,), daemon=True)
                           for i in range(len(prompts))]
                for t in threads:
                    t.start()
                return threads, replies

            hint = hints_for(names, 1, "fixture")[0][0]
            # the uninterrupted run: the 7 requests on worker-0
            t1 = time.perf_counter()
            threads, replies = run("b-ref", hint)
            join_posts(threads)
            ref_s = time.perf_counter() - t1
            if [replies[i][0] for i in range(len(prompts))] != [200] * len(prompts):
                raise AssertionError(f"fleet (h2): the uninterrupted run {replies}")
            ref = [replies[i][1]["completions"][0]["text"] for i in range(len(prompts))]

            # (h2) the same 7 on worker-0 again, SIGKILLed once its journal
            # holds their ACCEPTs
            rids = [f"b-kill-{i}" for i in range(len(prompts))]
            wdir = Path(handles[0].journal_dir)
            t1 = time.perf_counter()
            threads, replies = run("b-kill", hint)
            while time.perf_counter() - t1 < 60:
                entries = RequestJournal.read_state(wdir)[0] if wdir.exists() else {}
                if set(rids) <= set(entries):
                    break
                time.sleep(0.005)
            else:
                raise AssertionError(f"fleet (h2): worker-0's journal holds {sorted(entries)}")
            done_before = sum(entries[r].terminal for r in rids)
            victim = worker_rows(base)["worker-0"]["pid"]
            os.kill(victim, signal.SIGKILL)
            t_kill = time.perf_counter()
            join_posts(threads)
            answered_s = time.perf_counter() - t_kill
            statuses = [replies[i][0] for i in range(len(prompts))]
            texts = [replies[i][1]["completions"][0]["text"] if replies[i][0] == 200
                     else None for i in range(len(prompts))]
            ledger = [aggregate_status(state.journal.lookup(r)) for r in rids]
            _, mtext = serve_request("GET", base + "/metrics")
            failovers = sum(float(line.split()[-1]) for line in mtext.splitlines()
                            if line.startswith("vnsum_serve_router_failovers_total{"))
            if (statuses != [200] * len(prompts) or texts != ref
                    or ledger != ["completed"] * len(prompts) or failovers < 1):
                raise AssertionError(f"fleet (h2): statuses {statuses}, ledger {ledger}, "
                                     f"failovers {failovers}, {agreement(texts, ref)}")
            while True:
                row = worker_rows(base)["worker-0"]
                if row["up"] and row["pid"] != victim:
                    break
                if time.perf_counter() - t_kill > FLEET_READY_S:
                    raise AssertionError(f"fleet (h2): worker-0 not back: {row}")
                time.sleep(0.05)
            back_s = time.perf_counter() - t_kill
            log(f"[fleet] B (h2) failover: the uninterrupted run {ref_s:.3f}s; worker-0 "
                f"(pid {victim}) SIGKILLed with {len(rids) - done_before} of {len(rids)} "
                f"accepted requests unfinished: 7/7 answered 200 {answered_s:.3f}s after the "
                f"kill, byte-identical to the uninterrupted run, completed in the router "
                f"journal, router_failovers_total {failovers:.0f}; worker-0 respawned (pid "
                f"{row['pid']}, generation {handles[0].generation}, restarts {row['restarts']}) "
                f"and back in rotation {back_s:.1f}s after the kill")

            # (h3) rolling restart under a request every FLEET_RESTART_EVERY_S
            while not all(w.up for w in state.workers):
                if time.perf_counter() - t_kill > FLEET_READY_S:
                    raise AssertionError("fleet (h3): workers not up before the restart")
                time.sleep(0.05)
            gens = {h.name: h.generation for h in handles}
            out: dict = {n: [] for n in names}
            stop = threading.Event()

            def watch():
                prev = {n: True for n in names}
                while not stop.is_set():
                    now = time.perf_counter()
                    for w in state.workers:
                        ok = w.up and not w.draining
                        if ok != prev[w.name]:
                            if ok:
                                out[w.name][-1][1] = now
                            else:
                                out[w.name].append([now, None])
                            prev[w.name] = ok
                    time.sleep(0.01)

            watcher = threading.Thread(target=watch, daemon=True)
            watcher.start()
            t1 = time.perf_counter()
            status, body = serve_request("POST", base + "/admin/rolling-restart", {})
            if status != 202:
                raise AssertionError(f"fleet (h3): /admin/rolling-restart {status}: {body}")
            posts, replies, i = [], {}, 0
            seen_rolling = False
            while time.perf_counter() - t1 < 2 * FLEET_READY_S:
                rolling = state._rolling
                seen_rolling = seen_rolling or rolling
                if seen_rolling and not rolling:
                    break

                def post(i=i):
                    replies[i] = serve_request("POST", base + "/v1/generate", {
                        "prompt": prompts[i % len(prompts)], "max_new_tokens": 16,
                        "request_id": f"b-roll-{i}"})

                posts.append(threading.Thread(target=post, daemon=True))
                posts[-1].start()
                i += 1
                time.sleep(FLEET_RESTART_EVERY_S)
            join_posts(posts)
            roll_s = time.perf_counter() - t1
            stop.set()
            watcher.join(timeout=5)
            bad = {k: v for k, v in replies.items() if v[0] != 200}
            drains = {n: spied[n]["drains"][-1] if spied[n]["drains"] else None for n in names}
            if (not seen_rolling or bad or len(replies) != i
                    or any(d is None or d[1] != 0 or not d[2] for d in drains.values())
                    or {h.name: h.generation for h in handles}
                    != {n: g + 1 for n, g in gens.items()}
                    or not all(w.up for w in state.workers)
                    or any(not iv or iv[-1][1] is None for iv in out.values())):
                raise AssertionError(f"fleet (h3): failed replies {bad} of {i}, drains "
                                     f"{drains}, generations {gens} -> "
                                     f"{ {h.name: h.generation for h in handles} }, out of "
                                     f"rotation {out}")
            log(f"[fleet] B (h3) rolling restart: 202, then {i} requests every "
                f"{FLEET_RESTART_EVERY_S * 1000:.0f} ms through it, all 200; "
                + "; ".join(f"{n} drained rc {drains[n][1]} with its journal sealed, "
                            f"generation {gens[n]} -> {gens[n] + 1}, out of rotation "
                            f"{sum(b - a for a, b in out[n]):.1f}s" for n in names)
                + f"; {roll_s:.1f}s in all")
        finally:
            server.shutdown()
            server.server_close()
            t1 = time.perf_counter()
            state.close(drain_timeout_s=60)
            stop_s = time.perf_counter() - t1
        rcs = {h.name: h.last_rc for h in handles}
        left = [pid for pid in started if proc_alive(pid)]
        if set(rcs.values()) != {0} or left:
            raise AssertionError(f"fleet B stop: worker rcs {rcs}, pids left {left}")
        log(f"[fleet] B stop: the router drained both workers (rc 0) in {stop_s:.2f}s; wall "
            f"{time.perf_counter() - t0:.1f}s")


def phase_fleet(torch, serve_ref: tuple) -> None:
    """Phase 9e: fleet A then fleet B; every process the phase started is
    stopped, and gated gone, however it ends; no kernel library is built
    or rewritten by a worker."""
    libs = library_mtimes()
    started: set = set()
    cwd = Path.cwd()
    os.chdir(ROOT)  # the workers' `-m` imports this checkout's package
    try:
        fleet_a(torch, serve_ref, started)
        fleet_b(torch, started)
    finally:
        stop_pids(started)
        os.chdir(cwd)
    left = [pid for pid in started if proc_alive(pid)]
    if left:
        raise AssertionError(f"fleet: processes left {left}")
    if library_mtimes() != libs:
        raise AssertionError("fleet: a worker built or rewrote a kernel library")
    log(f"[fleet] {len(started)} processes started and none left; the {len(libs)} kernel "
        f"libraries unchanged (the workers loaded phase 2's builds)")


# -- phase 9f -----------------------------------------------------------------

# the checks around the engine (ROADMAP A14): (a) the transfer guard
# (VNSUM_SANITIZERS=transfer: CUDA's sync debug mode at "error" inside the
# engine's dispatch loops) on the spec phase's Llama-3.2-3B, each call's
# output byte for byte the same call's without the guard; (b) the engine's
# fault sites through the port's schedulers on the trained fixture; (c) the
# port's lint as a subprocess; (d) the pipeline phase's results.tracing
# (the profile phase holds the engine's annotate ranges and the captured
# step's wall).
CHECKS_SPEC_NEW = 32
CHECKS_SLOT_SEGMENT = 8
CHECKS_CHOICE_BYTES = 900    # score_choices' two prompts: S = 1024, C = S
# (b): 7 map prompts of the fixture, each a tagged head of its chunk
CHECKS_FAULT_TAG = "Tài-liệu-{}.\n"  # no space: the plan format splits on it
CHECKS_FAULT_CHARS = 1200
CHECKS_FAULT_NEW = 128
CHECKS_FAULT_SEGMENT = 8     # slot steps a segment: requests span many steps
CHECKS_POISON = 3
CHECKS_POLICY = dict(max_attempts=2, backoff_base_s=0.005, backoff_max_s=0.05, jitter=0.0)
# (name, scheduler, VNSUM_FAULTS plan, the firings it must make as (site,
# kind, call), the supervisor's failure classes counted, the ladder's rung
# after): the JAX engine's schedule and outcomes in the same scenario
# (tests/test_torch_engine_faults.py holds the JAX scheduler over TpuBackend
# to these on the CPU)
CHECKS_PLANS = (
    ("dispatch raise", "batch", "engine.dispatch:raise@on_call=1",
     (("engine.dispatch", "raise", 1),), {"transient": 1}, 0),
    ("slot step resource", "inflight", "engine.slot_step:resource@on_call=2",
     (("engine.slot_step", "resource", 2),), {"resource_exhausted": 1}, 0),
    ("dispatch poison", "batch",
     f"engine.dispatch:poison@match={CHECKS_FAULT_TAG.format(CHECKS_POISON).strip()}",
     (("engine.dispatch", "poison", 1), ("engine.dispatch", "poison", 2),
      ("engine.dispatch", "poison", 4), ("engine.dispatch", "poison", 5),
      ("engine.dispatch", "poison", 6)), {"transient": 5}, 0),
    ("slot admit raise", "inflight", "engine.slot_admit:raise@on_call=1",
     (("engine.slot_admit", "raise", 1),), {"transient": 1}, 0),
)
# (d): the runner's spans (core/profiling.Tracer) on the pipeline phase's
# run, with their counts: the JAX runner's on the same run
RUNNER_SPANS = {"analyze": 1, "summarize": 1, "summarize/batch": 1, "evaluate": 1,
                "evaluate/embedder_init": 1, "evaluate/embed": 1, "evaluate/bertscore": 1,
                "evaluate/rouge": 7}
PIPELINE_TRACING: dict = {}
# the profile phase: the captured decode step's wall in earlier runs (ms,
# PERF.md), and the margin over it that fails the run
CAPTURED_STEP_MS = (7.72, 8.09)
CAPTURED_STEP_MARGIN = 1.15


@contextlib.contextmanager
def sanitizers_env(value: str):
    """VNSUM_SANITIZERS set to ``value`` while open."""
    old = os.environ.get("VNSUM_SANITIZERS")
    os.environ["VNSUM_SANITIZERS"] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("VNSUM_SANITIZERS", None)
        else:
            os.environ["VNSUM_SANITIZERS"] = old


@contextlib.contextmanager
def mode_log(torch):
    """Every value the sync debug mode is set to while open, in order."""
    seen: list = []
    real = torch.cuda.set_sync_debug_mode

    def record(mode):
        seen.append(mode)
        real(mode)

    torch.cuda.set_sync_debug_mode = record
    try:
        yield seen
    finally:
        torch.cuda.set_sync_debug_mode = real


def check_guard_log(name: str, seen: list, mode_after) -> None:
    """The guard armed (the mode set to "error") and left the mode at 0."""
    if "error" not in seen:
        raise AssertionError(f"checks (a) {name}: the guard never armed (modes set: {seen})")
    if mode_after != 0:
        raise AssertionError(f"checks (a) {name}: the sync debug mode is {mode_after} after "
                             "the call, not 0")


def guarded(torch, name: str, fn):
    """``fn()`` under VNSUM_SANITIZERS=transfer: (its result, wall s)."""
    with sanitizers_env("transfer"), mode_log(torch) as seen:
        t0 = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t0
    check_guard_log(name, seen, torch.cuda.get_sync_debug_mode())
    return out, wall


def planted_sync(torch, sanitizers, dev, planted) -> str:
    """The planted fault of arm (a): ``planted()``, an unacknowledged sync,
    must raise inside the guard and pass inside ``acknowledged()``, and the
    mode must come back to 0. Returns the error's text."""
    with sanitizers_env("transfer"):
        try:
            with sanitizers.hot_path_transfer_guard(dev):
                try:
                    with sanitizers.acknowledged():
                        planted()
                except RuntimeError as e:
                    raise AssertionError(f"checks (a) planted: the sync raised inside "
                                         f"acknowledged(): {e}") from e
                planted()
        except RuntimeError as e:
            msg = str(e)
        else:
            raise AssertionError("checks (a) planted: an unacknowledged sync inside the "
                                 "guard did not raise: the guard is not live")
    if "synchroniz" not in msg:
        raise AssertionError(f"checks (a) planted: raised, but not as a sync: {msg}")
    if torch.cuda.get_sync_debug_mode() != 0:
        raise AssertionError("checks (a) planted: the mode was not restored")
    return msg


def checks_guard(torch, backend, prompts: list, oneshot: list) -> dict:
    """Arm (a) on the spec phase's backend (Llama-3.2-3B, full width and
    depth, int8 cache): generate on the 7 map prompts (captured decode: K1,
    K2) against the same backend's unguarded run of the spec phase; the
    spec path at CHECKS_SPEC_NEW new tokens with the one-shot outputs as
    references (K3 at Sq = 9); one slot-loop admit and step (K1, K3 at Sq =
    1) on a backend of the same model with CHECKS_SLOT_SEGMENT steps a
    segment; score_choices on two prompts (K1 at C = S). Each guarded call
    byte-identical to its unguarded twin, the guard armed and the mode back
    at 0 after it; then the planted sync. Returns the arm's launches, exact
    against the engine records."""
    from vnsum_tpu_torch.analysis import sanitizers
    from vnsum_tpu_torch.backend.engine import TorchBackend

    dev = backend.device
    n_layers = backend.cfg.n_layers
    slot_b = TorchBackend(model=backend.model, batch_size=8, max_new_tokens=128,
                          segment_tokens=CHECKS_SLOT_SEGMENT, device="cuda")
    st, sst = backend.stats, slot_b.stats
    before = (st.prefill_forwards, st.decode_steps, st.spec_verify_steps,
              sst.prefill_forwards, sst.decode_steps)
    reset_launches()
    walls = {}
    got, walls["generate"] = guarded(torch, "generate", lambda: backend.generate(prompts))
    if got != oneshot:
        raise AssertionError("checks (a) generate: guarded outputs differ from the unguarded "
                             f"run's: {agreement(got, oneshot)}")

    def spec():
        return backend.generate(prompts, references=oneshot, max_new_tokens=CHECKS_SPEC_NEW)

    t0 = time.perf_counter()
    want = spec()
    plain = {"spec": time.perf_counter() - t0}
    steps0 = st.spec_verify_steps
    got, walls["spec"] = guarded(torch, "spec", spec)
    if got != want:
        raise AssertionError(f"checks (a) spec: guarded outputs differ: {agreement(got, want)}")
    if st.spec_verify_steps == steps0:
        raise AssertionError("checks (a) spec: the guarded call ran no verify step")

    def slot_once():
        loop = slot_b.start_slot_loop(8, prompt_tokens=max(s for _b, s in PIPELINE_SHAPES))
        try:
            adm, rejected = loop.admit([(i, p, None) for i, p in enumerate(prompts)])
            res = loop.step()
            return (len(adm), rejected, res.new_tokens, loop._out_snap.tolist(),
                    loop._t_host.tolist(), [(c.key, c.text) for c in res.completions])
        finally:
            loop.close()

    t0 = time.perf_counter()
    want = slot_once()
    plain["slot"] = time.perf_counter() - t0
    slot, walls["slot"] = guarded(torch, "slot loop", slot_once)
    if slot != want or slot[0] != len(prompts):
        raise AssertionError(f"checks (a) slot loop: guarded admit + step differ "
                             f"({slot[:3]} against {want[:3]})")

    short = [p.encode()[:CHECKS_CHOICE_BYTES].decode("utf-8", "ignore") for p in prompts[:2]]
    t0 = time.perf_counter()
    want = backend.score_choices(short, CHOICE_DIGITS)
    plain["score_choices"] = time.perf_counter() - t0
    got, walls["score_choices"] = guarded(
        torch, "score_choices", lambda: backend.score_choices(short, CHOICE_DIGITS))
    if got != want:
        raise AssertionError(f"checks (a) score_choices: guarded picks {got} against {want}")
    launches = read_launches()
    after = (st.prefill_forwards, st.decode_steps, st.spec_verify_steps,
             sst.prefill_forwards, sst.decode_steps)
    d = [a - b for a, b in zip(after, before)]
    check_exact("checks (a) guarded and unguarded calls", launches, {
        "prefill": n_layers * (d[0] + d[3]), "decode": n_layers * d[1],
        "verify": n_layers * (d[2] + d[4])}, ("prefill", "decode", "verify"))
    msg = planted_sync(torch, sanitizers, dev, lambda: torch.ones(1, device=dev).item())
    log(f"[checks] (a) guard on Llama-3.2-3B, guarded (unguarded twin, run first): "
        f"generate (7 map prompts, captured decode) {walls['generate']:.3f}s, spec at "
        f"{CHECKS_SPEC_NEW} new tokens {walls['spec']:.3f}s ({plain['spec']:.3f}s), slot "
        f"admit + step ({slot[0]} joins, {slot[2]} tokens) {walls['slot']:.3f}s "
        f"({plain['slot']:.3f}s), score_choices (2 prompts) {walls['score_choices']:.3f}s "
        f"({plain['score_choices']:.3f}s): each byte-identical to its twin, the mode 0 after "
        f"each; the planted .item() raised: {msg.splitlines()[0][:100]}")
    del slot_b
    return launches


def fault_prompts(docs) -> list:
    """Arm (b)'s prompts: the map template over each document's first
    CHECKS_FAULT_CHARS characters, tagged with its index (the poison
    plan's match)."""
    from vnsum_tpu_torch.strategies.prompts import MAPREDUCE_MAP

    return [MAPREDUCE_MAP.format(content=CHECKS_FAULT_TAG.format(i) + d[:CHECKS_FAULT_CHARS])
            for i, d in enumerate(docs)]


def fault_outcomes(serve, faults, backend, prompts: list, kind: str, plan_text: str | None,
                   timeout: float = 600.0) -> dict:
    """One fault plan through a supervised scheduler of ``serve`` (a
    package's serve module: the port's here, the JAX package's too in the
    CPU test) over ``backend``: ``kind`` "batch" (MicroBatchScheduler) or
    "inflight" (InflightScheduler), CHECKS_POLICY's retries, every prompt
    submitted at once. Returns the firings, each request's outcome ("ok",
    text) or ("failed", class), the failures by class, retries, bisects,
    quarantined and the ladder's rung."""
    sup = serve.EngineSupervisor(serve.RetryPolicy(**CHECKS_POLICY))
    cls = serve.MicroBatchScheduler if kind == "batch" else serve.InflightScheduler
    sched = cls(backend, max_batch=8, max_wait_s=0.2, supervisor=sup)
    plan = faults.parse_plan(plan_text) if plan_text else None
    outcomes = []
    try:
        with faults.injected(plan) if plan else contextlib.nullcontext():
            futs = [sched.submit(p) for p in prompts]
            for f in futs:
                try:
                    outcomes.append(("ok", f.result(timeout=timeout).text))
                except serve.RequestFailed as e:
                    outcomes.append(("failed", e.failure_class.value))
        snap = sched.metrics.snapshot()
    finally:
        sched.close()
    return {"fired": [tuple(f) for f in plan.fired] if plan else [], "outcomes": outcomes,
            "failures": dict(snap.failures), "retries": snap.retries, "bisects": snap.bisects,
            "quarantined": snap.quarantined, "rung": int(sup.rung)}


def check_plan(name: str, got: dict, fired, failures: dict, rung: int, base: list,
               poison: int | None) -> None:
    """One plan's gate: exactly the firings expected, the failure classes
    and rung expected, the poisoned request (if any) failed POISON and
    every other answer byte for byte the unfaulted run's."""
    if got["fired"] != [tuple(f) for f in fired]:
        raise AssertionError(f"checks (b) {name}: fired {got['fired']}, expected {list(fired)}")
    if got["failures"] != failures or got["rung"] != rung:
        raise AssertionError(f"checks (b) {name}: failures {got['failures']} at rung "
                             f"{got['rung']}, expected {failures} at rung {rung}")
    want = [("failed", "poison") if i == poison else ("ok", t) for i, t in enumerate(base)]
    if got["outcomes"] != want:
        bad = [i for i, (g, w) in enumerate(zip(got["outcomes"], want)) if g != w]
        raise AssertionError(f"checks (b) {name}: requests {bad} differ from the unfaulted "
                             f"run's ({[got['outcomes'][i][0] for i in bad]})")
    if poison is not None and got["quarantined"] != 1:
        raise AssertionError(f"checks (b) {name}: {got['quarantined']} quarantined, not 1")


def checks_faults(torch, device: str = "cuda") -> dict:
    """Arm (b): the trained fixture (its own tokenizer, int8 cache on the
    card) behind the port's supervised schedulers, each plan of
    CHECKS_PLANS armed in turn (check_plan), against the backend's
    unfaulted generate. Returns the arm's launches and its seconds a plan."""
    from vnsum_tpu_torch import serve
    from vnsum_tpu_torch.backend.engine import TorchBackend
    from vnsum_tpu_torch.models.convert import load_hf_checkpoint
    from vnsum_tpu_torch.testing import faults

    model = load_hf_checkpoint(str(FIXTURE_DIR), device=device)[1]
    backend = TorchBackend(model=model, tokenizer=f"hf:{FIXTURE_DIR}", batch_size=8,
                           max_new_tokens=CHECKS_FAULT_NEW, segment_tokens=CHECKS_FAULT_SEGMENT,
                           seed=0, device=device)
    docs = [p.read_text(encoding="utf-8")
            for p in sorted((ROOT / "data/vi_eval/doc").glob("*.txt"))]
    prompts = fault_prompts(docs)
    reset_launches()
    base = backend.generate(prompts)
    if not all(base):
        raise AssertionError(f"checks (b): the unfaulted run has empty answers: {base}")
    walls = {}
    for name, kind, plan, fired, failures, rung in CHECKS_PLANS:
        t0 = time.perf_counter()
        got = fault_outcomes(serve, faults, backend, prompts, kind, plan)
        walls[name] = time.perf_counter() - t0
        poison = CHECKS_POISON if "poison" in plan else None
        check_plan(name, got, fired, failures, rung, base, poison)
        log(f"[checks] (b) {name} ({kind}, {plan}): fired {got['fired']}, failures "
            f"{got['failures']}, retries {got['retries']}, bisects {got['bisects']}, "
            f"quarantined {got['quarantined']}, rung {got['rung']}; "
            f"{sum(o[0] == 'ok' for o in got['outcomes'])}/{len(prompts)} answers byte-"
            f"identical to the unfaulted run's, {walls[name]:.2f}s")
    launches = read_launches()
    if not (launches["prefill"] and launches["decode"] and launches["verify"]) \
            and device == "cuda":
        raise AssertionError(f"checks (b): launches {launches}: a kernel of the path never ran")
    del backend, model
    return launches


def checks_lint() -> str:
    """Arm (c): ``python -m vnsum_tpu_torch.analysis vnsum_tpu_torch`` as a
    subprocess from the checkout's root must exit 0 with no finding."""
    import importlib.util

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "vnsum_tpu_torch.analysis", "vnsum_tpu_torch"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    if proc.returncode != 0 or proc.stdout.strip() != "ok: no findings":
        raise AssertionError(f"checks (c): the lint exited {proc.returncode}:\n"
                             f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
    have = {m: importlib.util.find_spec(m) is not None for m in ("jax", "transformers")}
    return f"exit 0, ok: no findings, {wall:.2f}s (importable here: {have})"


def check_tracing(label: str, tracing: dict) -> None:
    """Arm (d): a pipeline run's ``results.tracing``: the runner's spans,
    RUNNER_SPANS' names and counts."""
    spans = tracing.get("spans", {})
    counts = {k: v["count"] for k, v in spans.items()}
    if counts != RUNNER_SPANS or not all(v["total_s"] >= 0 for v in spans.values()):
        raise AssertionError(f"{label}: results.tracing spans {counts}, expected "
                             f"{RUNNER_SPANS}")


def phase_checks(torch, backend, prompts: list, oneshot: list) -> dict:
    """Phase 9f: arms (a)-(d) (see above). Returns the phase's launches."""
    total = dict.fromkeys(COUNTERS, 0)
    t0 = time.perf_counter()
    a = checks_guard(torch, backend, prompts, oneshot)
    ta = time.perf_counter() - t0
    b = checks_faults(torch)
    tb = time.perf_counter() - t0 - ta
    lint = checks_lint()
    log(f"[checks] (c) python -m vnsum_tpu_torch.analysis vnsum_tpu_torch: {lint}")
    check_tracing("checks (d) the pipeline phase", PIPELINE_TRACING)
    log("[checks] (d) the pipeline phase's results.tracing: "
        + ", ".join(f"{k} x{v['count']} {v['total_s']:.3f}s"
                    for k, v in PIPELINE_TRACING["spans"].items()))
    for k in total:
        total[k] = a[k] + b[k]
    log(f"[checks] arms: (a) {ta:.1f}s, (b) {tb:.1f}s, (c) + (d) "
        f"{time.perf_counter() - t0 - ta - tb:.1f}s")
    log("[launches] checks phase: " + ", ".join(f"{k} {v}" for k, v in total.items()))
    torch.cuda.empty_cache()
    return total


# -- phase 9g -----------------------------------------------------------------

# phase 9g (ROADMAP A10a): (a) the 1x1 mesh on the spec phase's model, the
# one-shot map batch at 128 new tokens and the spec path at MESH_SPEC_NEW;
# (c) two ranks on the one card, a model = 2 mesh over gloo, Llama-3.2-3B
# at full width and MESH_TP_LAYERS of its 28 layers, the map batch at
# MESH_TP_NEW new tokens, eager
MESH_SPEC_NEW = CHECKS_SPEC_NEW
MESH_TP_LAYERS = 4
MESH_TP_NEW = 16
MESH_TP_JOIN_S = 300
# the decode steps after the prefill whose logits (c) gates
MESH_GATE_STEPS = 4
# (c)'s gate: the model = 2 forward's logits against the unsharded
# engine's on the same weights, as max |tp - one| over the document rows
# (a decode step: the rows whose greedy ids so far agree) and the vocab,
# divided by the largest |one| logit. The two run the same bf16 weights
# through the same kernels on the local heads; they differ where the
# shards sum: each rank rounds its partial products of wo and w_down to
# bf16 (2^-9 relative) before the all-reduce adds them in bf16, where the
# unsharded GEMM rounds once, two such roundings a layer carried through
# 4 layers and the final norm; the embedding's and the logits' all-reduces
# are exact (one contributor an element). The spec and dense gates hold
# roundings of this order carried through 28 layers to 0.1: so does this
# one. The planted fault must exceed it: rank 1 leaves out its all-reduce
# of w_down's partial product on layer 1 (it issues the collective on a
# copy and keeps its own partial, so the two ranks stay in step), a
# monkeypatch in its own process; rank 1's activations from there on miss
# rank 0's half of that MLP, and so does its half of the vocab's logits.
MESH_TP_RTOL = 0.1
# the collectives of one forward of the model = 2 engine, in order: the
# embedding's, wo's and w_down's on each layer, the logits'; the fault
# leaves out layer 1's w_down (index 4)
MESH_FAULT_CALL = 4


class SkipOneAllReduce:
    """A ``model`` group stand-in for one rank: the all-reduce at
    ``index`` of every ``per_forward`` calls is issued on a copy and its
    result dropped (the rank keeps its own partial sum); everything else
    goes to ``group``."""

    def __init__(self, group, index: int, per_forward: int) -> None:
        self.group, self.index, self.per_forward, self.calls = group, index, per_forward, 0

    def __getattr__(self, name):
        return getattr(self.group, name)

    def all_reduce_sum(self, t):
        k = self.calls % self.per_forward
        self.calls += 1
        if k == self.index:
            self.group.all_reduce_sum(t.clone())
            return t
        return self.group.all_reduce_sum(t)


@contextlib.contextmanager
def sampled_logits(steps: int):
    """While open, TorchBackend's sampler records (logits of each row's
    last position, f32 on the host; the ids it picks) for its first
    ``steps`` calls: the prefill's, then the decode steps'."""
    from vnsum_tpu_torch.backend.engine import TorchBackend

    seen: list = []
    sample = TorchBackend._sample

    def spy(self, logits, *args, **kw):
        ids = sample(self, logits, *args, **kw)
        if len(seen) < steps:
            seen.append((logits[:, -1, :].float().cpu(), ids.cpu()))
        return ids

    TorchBackend._sample = spy
    try:
        yield seen
    finally:
        TorchBackend._sample = sample


def reset_calls() -> None:
    from vnsum_tpu_torch.ops import sharded

    sharded.prefill_calls = sharded.decode_calls = 0


def map_batch_chunks(backend) -> tuple[list, list]:
    """The map batch's prompts and their chunks (the spec path's
    references), as the pipeline builds them."""
    from vnsum_tpu_torch.core.config import PipelineConfig
    from vnsum_tpu_torch.strategies import get_strategy

    docs = sorted((ROOT / "data/vi_eval/doc").glob("*.txt"))
    cfg = PipelineConfig(approach="mapreduce", models=["llama3.2:3b"], max_new_tokens=128)
    strategy = get_strategy("mapreduce", backend, cfg)
    chunks = [c for d in docs for c in strategy.splitter.split_text(d.read_text(encoding="utf-8"))]
    return [strategy.map_prompt.format(content=c) for c in chunks], chunks


def mesh_one_by_one(torch, model, oneshot: list) -> dict:
    """(a): init_distributed forms a world-1 NCCL group from MASTER_ADDR /
    MASTER_PORT; TorchBackend(mesh=make_mesh({})) shares ``model`` and runs
    the map batch (B=8, S=4096, 128 new tokens, int8 cache, captured
    steps) and the spec path (spec_k 8, MESH_SPEC_NEW new tokens, the
    chunks as references), each byte-identical (texts and generated id
    rows) to the unmeshed engine's on the same weights and prompts: the
    spec phase's one-shot run (``oneshot``, ONESHOT_ROWS) and a spec run
    here. K1, K2 and K3 launches and the mesh wrappers' calls exact.
    Returns the launches."""
    import torch.distributed as dist

    from vnsum_tpu_torch.backend import capture
    from vnsum_tpu_torch.backend.engine import TorchBackend
    from vnsum_tpu_torch.core.config import GenerationConfig
    from vnsum_tpu_torch.parallel import init_distributed, make_mesh
    from vnsum_tpu_torch.testing.chaos import free_port

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()), WORLD_SIZE="1",
                      RANK="0", LOCAL_RANK="0")
    t0 = time.perf_counter()
    if not init_distributed():
        raise AssertionError("mesh (a): init_distributed() stayed in local mode")
    probe = torch.ones(4, device="cuda")
    dist.all_reduce(probe)
    log(f"[mesh] (a) init_distributed: {dist.get_backend()} group of {dist.get_world_size()} "
        f"in {time.perf_counter() - t0:.2f}s, an all-reduce {probe.tolist()}")
    if dist.get_backend() != "nccl" or probe.tolist() != [1.0] * 4:
        raise AssertionError("mesh (a): the world-1 group is not NCCL or its all-reduce is wrong")
    total = dict.fromkeys(COUNTERS, 0)
    try:
        mesh = make_mesh({})
        n_layers = model.cfg.n_layers
        for what, max_new, gen_kw in (("one-shot", 128, {}), ("spec", MESH_SPEC_NEW,
                                                            {"spec_k": 8})):
            kw = dict(batch_size=8, max_new_tokens=max_new, generation=GenerationConfig(**gen_kw),
                      device="cuda")
            meshed = TorchBackend(model=model, mesh=mesh, **kw)
            if meshed.model.embed.data_ptr() != model.embed.data_ptr():
                raise AssertionError("mesh (a): the 1x1 shard copied the model")
            prompts, chunks = map_batch_chunks(meshed)
            refs = {"references": chunks} if gen_kw else {}
            t0 = time.perf_counter()
            if gen_kw:
                with recorded_rows() as want_rows:
                    want = TorchBackend(model=model, **kw).generate(prompts, **refs)
            else:
                want, want_rows = oneshot, ONESHOT_ROWS
            plain_s = time.perf_counter() - t0
            reset_launches()
            reset_calls()
            t0 = time.perf_counter()
            with recorded_rows() as got_rows:
                got = meshed.generate(prompts, **refs)
            wall = time.perf_counter() - t0
            launches, calls = read_launches(), capture.read_calls()
            st = meshed.stats
            need = {"prefill": n_layers * st.prefill_forwards,
                    "decode": n_layers * st.decode_steps,
                    "verify": n_layers * st.spec_verify_steps}
            check_exact(f"mesh (a) 1x1 {what}", launches, need,
                        ("prefill", "verify") if gen_kw else ("prefill", "decode"))
            if calls != {"sharded_prefill": need["prefill"], "sharded_decode": need["decode"]}:
                raise AssertionError(f"mesh (a) {what}: the mesh wrappers' calls {calls}, the "
                                     f"engine record implies K1 {need['prefill']}, K2 "
                                     f"{need['decode']}")
            if got != want or got_rows != want_rows or not got_rows:
                raise AssertionError(f"mesh (a) {what}: the 1x1 mesh's outputs differ from the "
                                     f"unmeshed engine's: {agreement(got, want)}")
            if gen_kw and st.spec_verify_steps == 0:
                raise AssertionError("mesh (a) spec: no verify step ran")
            if not gen_kw:
                check_captured("mesh (a) one-shot", st.to_dict())
            for k in total:
                total[k] += launches[k]
            log(f"[mesh] (a) 1x1 {what}: {len(prompts)} map prompts byte-identical to the "
                f"unmeshed engine ({sum(map(len, got))} chars, {len(got_rows)} id rows equal), "
                f"wall {wall:.2f}s ("
                + (f"unmeshed {plain_s:.2f}s" if gen_kw else "the spec phase's unmeshed run")
                + f"), prefill forwards "
                f"{st.prefill_forwards}, decode steps {st.decode_steps} ({st.captured_steps} "
                f"replays), verify steps {st.spec_verify_steps}; the wrappers' calls {calls}")
            del meshed
    finally:
        dist.destroy_process_group()
        for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
            os.environ.pop(var, None)
    torch.cuda.empty_cache()
    return total


def mesh_rank(rank: int, init_file: str, out_dir: str) -> None:
    """(c)'s rank ``rank`` of 2, in a process of its own on card 0: the
    probe (gloo all-reduces a bf16 CUDA tensor), then init_distributed
    accepting the group this process formed, a model = 2 mesh over it, and
    the engine on Llama-3.2-3B at MESH_TP_LAYERS layers (the whole model
    from seed 0, sharded by the engine): generate on the map batch with
    its sampler's logits recorded, launches read; then rank 1's planted
    fault and the generate again. Publishes what it saw (rank{r}.pt; a
    failure as its traceback), then runs phase 9i (c)'s training step
    (train_rank), which waits for phase 9i's "go" file, and publishes that
    (train{r}.pt); then 9i (d) and (e) (train_rank_arm), published as
    arms{r}.pt."""
    import datetime
    import traceback

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    out: dict = {}
    dist.init_process_group("gloo", init_method=f"file://{init_file}", world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=MESH_TP_JOIN_S - 60))
    try:
        try:
            out, mesh = mesh_rank_generate(torch, rank)
        except Exception:
            out["error"] = traceback.format_exc()
        publish(torch, out, Path(out_dir) / f"rank{rank}.pt")
        if "error" not in out:
            try:
                train = train_rank(torch, rank, mesh, Path(out_dir) / "go")
            except Exception:
                train = {"error": traceback.format_exc()}
            whole, tokens = train.pop("whole", None), torch.from_numpy(train_batch()).to("cuda")
            publish(torch, train, Path(out_dir) / f"train{rank}.pt")
            arms = {}
            if whole is not None:
                try:
                    for arm in TRAIN_ARMS:
                        arms[arm] = train_rank_arm(torch, rank, arm, whole, tokens)
                except Exception:
                    arms["error"] = traceback.format_exc()
            del whole
            publish(torch, arms, Path(out_dir) / f"arms{rank}.pt")
    finally:
        dist.destroy_process_group()


def publish(torch, obj, path: Path) -> None:
    """torch.save ``obj`` to ``path`` whole: written beside it, then renamed."""
    tmp = path.with_suffix(".part")
    torch.save(obj, tmp)
    os.replace(tmp, path)


def mesh_rank_generate(torch, rank: int) -> tuple[dict, object]:
    """mesh_rank's inference gates: (what it saw, its mesh)."""
    import torch.distributed as dist

    from vnsum_tpu_torch.backend import capture
    from vnsum_tpu_torch.backend.engine import TorchBackend
    from vnsum_tpu_torch.models import llama32_3b
    from vnsum_tpu_torch.models.llama import init_model
    from vnsum_tpu_torch.parallel import init_distributed, make_mesh

    out: dict = {}
    probe = torch.full((8,), float(rank + 1), dtype=torch.bfloat16, device="cuda")
    dist.all_reduce(probe)
    out["probe"] = probe.float().tolist()
    out["accepted"] = init_distributed(device="cuda")
    mesh = make_mesh({"model": 2})
    out["coords"], out["capturable"] = dict(mesh.coords), mesh.captures_collectives()
    engine = TorchBackend(model=init_model(llama32_3b(n_layers=MESH_TP_LAYERS), 0, "cuda"),
                          mesh=mesh, batch_size=8, max_new_tokens=MESH_TP_NEW,
                          cuda_graphs=False, device="cuda")
    out["local_heads"] = (tuple(engine.model.layers["wq"].shape),
                          tuple(engine.model.layers["wk"].shape))
    prompts, _ = map_batch_chunks(engine)
    reset_launches()
    reset_calls()
    t0 = time.perf_counter()
    with sampled_logits(MESH_GATE_STEPS + 1) as seen, recorded_rows() as rows:
        out["texts"] = engine.generate(prompts)
    out["wall"] = time.perf_counter() - t0
    st = engine.stats
    out.update(launches=read_launches(), calls=capture.read_calls(), rows=rows,
               logits=seen, forwards=st.prefill_forwards, steps=st.decode_steps,
               prefill_s=st.phase_seconds.get("prefill", 0.0),
               decode_s=st.phase_seconds.get("decode", 0.0))
    # the planted fault: rank 1 leaves out layer 1's w_down all-reduce
    if rank == 1:
        engine.model.tp = SkipOneAllReduce(engine.model.tp, MESH_FAULT_CALL,
                                           2 * MESH_TP_LAYERS + 2)
    with sampled_logits(1) as seen:  # the prefill's logits: one new token does
        engine.generate(prompts, max_new_tokens=1)
    out["fault_logits"] = seen
    del engine
    torch.cuda.empty_cache()
    return out, mesh


def logits_measure(torch, tp: list, one: list, n_rows: int) -> list:
    """Per sampler call, max |tp - one| / max |one| over the first
    ``n_rows`` rows (the documents'), a decode step's over the rows whose
    sampled ids so far agree; and the rows each call compared."""
    out, agree = [], torch.ones(n_rows, dtype=torch.bool)
    for (lt, it), (lo, io) in zip(tp, one):
        rows = agree.nonzero()[:, 0]
        if len(rows):
            a, b = lt[rows], lo[rows]
            out.append((float((a - b).abs().max() / b.abs().max()), len(rows)))
        agree = agree & (it[:n_rows] == io[:n_rows])
    return out


def collect(torch, procs: list, paths: list, deadline: float, what: str) -> list:
    """What each rank published at ``paths`` (its process still running or
    done), once every file is there; raises when a rank exits without its
    file or ``deadline`` (perf_counter) passes."""
    while not all(p.is_file() for p in paths):
        gone = [r for r, (proc, path) in enumerate(zip(procs, paths))
                if not proc.is_alive() and not path.is_file()]
        if gone:
            raise AssertionError(f"{what}: ranks {gone} exited without saving "
                                 f"(exit {[procs[r].exitcode for r in gone]})")
        if time.perf_counter() > deadline:
            raise AssertionError(f"{what}: ranks did not save in time")
        time.sleep(0.05)
    return [torch.load(p, weights_only=False) for p in paths]


def mesh_two_ranks(torch, procs: list, tmp: str, t0: float) -> dict:
    """(c): the two ranks (mesh_rank), spawned on the one card at the
    phase's start (``procs``, publishing into ``tmp``), while this process
    runs the unsharded engine on the same weights and prompts; then the
    probe, each rank's launches (exact), the gate and its planted fault,
    and greedy agreement (not gated: random weights give near-ties).
    The ranks go on to phase 9i's training step. Returns each kernel's
    launches, summed over the ranks."""
    from vnsum_tpu_torch.backend.engine import TorchBackend
    from vnsum_tpu_torch.models import llama32_3b
    from vnsum_tpu_torch.models.llama import init_model

    one = TorchBackend(model=init_model(llama32_3b(n_layers=MESH_TP_LAYERS), 0, "cuda"),
                       batch_size=8, max_new_tokens=MESH_TP_NEW, cuda_graphs=False,
                       device="cuda")
    prompts, _ = map_batch_chunks(one)
    with sampled_logits(MESH_GATE_STEPS + 1) as want, recorded_rows() as want_rows:
        want_texts = one.generate(prompts)
    del one
    torch.cuda.empty_cache()
    ranks = collect(torch, procs, [Path(tmp) / f"rank{r}.pt" for r in range(2)],
                    t0 + MESH_TP_JOIN_S, "mesh (c)")
    wall = time.perf_counter() - t0
    for r, res in enumerate(ranks):
        if "error" in res:
            raise AssertionError(f"mesh (c) rank {r}:\n{res['error']}")
    if [res["probe"] for res in ranks] != [[3.0] * 8] * 2:
        raise AssertionError(f"mesh (c): the probe's all-reduce gave {ranks[0]['probe']}")
    log("[mesh] (c) probe: two gloo ranks on the one card all-reduce a bf16 CUDA tensor "
        "(1 + 2 = 3 on both)")
    total = dict.fromkeys(COUNTERS, 0)
    for r, res in enumerate(ranks):
        n = MESH_TP_LAYERS
        if not res["accepted"] or res["coords"] != {"data": 0, "model": r, "seq": 0}:
            raise AssertionError(f"mesh (c) rank {r}: accepted {res['accepted']}, coords "
                                 f"{res['coords']}")
        if res["capturable"]:
            raise AssertionError(f"mesh (c) rank {r}: a gloo mesh reads as capturable")
        need = {"prefill": n * res["forwards"], "decode": n * res["steps"]}
        check_exact(f"mesh (c) rank {r}", res["launches"], need, ("prefill", "decode"))
        if res["calls"] != {"sharded_prefill": need["prefill"], "sharded_decode": need["decode"]}:
            raise AssertionError(f"mesh (c) rank {r}: the mesh wrappers' calls {res['calls']}")
        for k in total:
            total[k] += res["launches"][k]
        log(f"[mesh] (c) rank {r}: wq {res['local_heads'][0]}, wk {res['local_heads'][1]}, "
            f"generate wall {res['wall']:.2f}s (prefill {res['prefill_s']:.3f}s, decode "
            f"{res['decode_s']:.3f}s, {res['steps']} eager steps)")
    # the all-reduced logits are the same bits on both ranks
    for (a, ia), (b, ib) in zip(ranks[0]["logits"], ranks[1]["logits"]):
        if not torch.equal(a, b) or not torch.equal(ia, ib):
            raise AssertionError("mesh (c): the two ranks' logits or picks differ")
    if ranks[0]["texts"] != ranks[1]["texts"]:
        raise AssertionError("mesh (c): the two ranks returned different texts")
    n_docs = len(prompts)
    sound = logits_measure(torch, ranks[0]["logits"], want, n_docs)
    fault = logits_measure(torch, ranks[0]["fault_logits"], want[:1], n_docs)
    worst = max(m for m, _ in sound)
    log(f"[mesh] (c) gate, model = 2 against the unsharded engine: per call (the prefill, then "
        f"decode steps: rows compared) "
        + ", ".join(f"{m:.3e} ({n})" for m, n in sound)
        + f"; the planted fault (rank 1 leaves out layer 1's w_down all-reduce) "
        f"{fault[0][0]:.3e}; limit {MESH_TP_RTOL}")
    if worst > MESH_TP_RTOL or fault[0][0] <= MESH_TP_RTOL or len(sound) != MESH_GATE_STEPS + 1:
        raise AssertionError(f"mesh (c): gate {worst:.3e}, planted fault {fault[0][0]:.3e}, "
                             f"limit {MESH_TP_RTOL}")
    log(f"[mesh] (c) greedy agreement with the unsharded engine (not gated: random weights "
        f"give near-ties): texts {agreement(ranks[0]['texts'], want_texts)}, id rows "
        f"{sum(a == b for a, b in zip(ranks[0]['rows'], want_rows))}/{len(want_rows)} equal; "
        f"the two ranks' texts equal; wall {wall:.1f}s since the ranks started")
    log("[launches] mesh (c), both ranks: " + ", ".join(f"{k} {v}" for k, v in total.items()))
    return total


def phase_mesh(torch, model, oneshot: list) -> tuple[dict, dict, dict]:
    """Phase 9g: (c)'s two ranks spawned first, so that they start up while
    (a) runs on ``model`` (mesh_one_by_one); then the rest of (c)
    (mesh_two_ranks). Returns ((a)'s launches, (c)'s, the ranks: still
    running, they build their trainers while phase 9h runs and train at
    phase 9i's "go"; stop_ranks stops them). Stops them if it fails."""
    import multiprocessing

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="vnsum_mesh_")
    ctx = multiprocessing.get_context("spawn")
    started = {"root": Path(tmp), "t0": t0, "procs": [
        ctx.Process(target=mesh_rank, args=(r, str(Path(tmp) / "rendezvous"), tmp), daemon=True)
        for r in range(2)]}
    try:
        for p in started["procs"]:
            p.start()
        a = mesh_one_by_one(torch, model, oneshot)
        ta = time.perf_counter() - t0
        c = mesh_two_ranks(torch, started["procs"], tmp, t0)
    except BaseException:
        stop_ranks(started)
        raise
    log(f"[mesh] arms: (a) {ta:.1f}s, then (c) {time.perf_counter() - t0 - ta:.1f}s (its ranks "
        "started with (a))")
    log("[launches] mesh (a): " + ", ".join(f"{k} {v}" for k, v in a.items()))
    return a, c, started


# -- phase 9h -----------------------------------------------------------------

# phase 9h (ROADMAP A10b): the pipeline CLI's whole-document launch as
# torchrun starts it, one process a card, here two ranks sharing the one
# card over gloo: --approach truncated --long-context --mesh seq=2 on
# Llama-3.2-3B at full width and LONG_MESH_LAYERS of its 28 layers, over
# path (c)'s two documents (both past the one-card ceiling), at
# LONG_MESH_NEW new tokens. max_context LONG_MESH_CONTEXT gives the
# backend max_total_tokens = max_context + 1024 = LONG_MESH_BUCKET, the
# bucket of the longer prompt: LONG_MESH_SHARD slots a rank
LONG_MESH_LAYERS = 4
LONG_MESH_NEW = 32
LONG_MESH_CONTEXT = 24576
LONG_MESH_BUCKET = LONG_MESH_CONTEXT + 1024
LONG_MESH_SHARD = LONG_MESH_BUCKET // 2
LONG_MESH_JOIN_S = 300
LONG_MESH_GATE_STEPS = 4
# the gate: the two ranks' logits against a one-rank backend's on the same
# weights and prompts, 9g (c)'s measure and limit (max |mesh - one| over
# the rows whose greedy ids so far agree and the vocab, over the largest
# |one| logit). They differ by bf16 rounding and by the prefill's
# attention: the plain f32 ring over two shards against K1 (which rounds p
# to bf16 before PV); the decode's K2p partials over two shards, merged,
# against one over the whole cache. The planted fault must exceed it: rank
# 1 issues its seq all-reduce of the K2p partials' o on a copy and keeps
# its own partial, on every layer (SkipOneAllReduce), so its attention
# misses rank 0's half of the prompt
LONG_MESH_RTOL = 0.1
# the planted fault runs on the prompts' first LONG_MESH_FAULT_BYTES bytes
# (a 4096-slot bucket) at 2 new tokens: what it breaks is the decode's
# merge, which any prompt length shows, and its prefill costs ~1/40 of the
# whole prompts'
LONG_MESH_FAULT_BYTES = 4000


def long_mesh_fault_prompts(prompts: list) -> list:
    return [p.encode()[:LONG_MESH_FAULT_BYTES].decode("utf-8", "ignore") for p in prompts]


def long_mesh_cut():
    from vnsum_tpu_torch.models import llama32_3b

    return llama32_3b(n_layers=LONG_MESH_LAYERS)


def long_mesh_argv(root: Path) -> list:
    """The CLI's argv, the same on both ranks, as torchrun would pass it."""
    argv = ["--approach", "truncated", "--long-context", "--mesh", "seq=2",
            "--max-context", str(LONG_MESH_CONTEXT), "--max-new-tokens", str(LONG_MESH_NEW),
            "--batch-size", "2", "--device", "cuda", "--models", "llama3.2:3b",
            "--docs-dir", str(root / "corpus/doc"), "--summary-dir", str(root / "corpus/summary")]
    for name in ("generated_summaries_dir", "results_dir", "logs_dir"):
        argv += ["--" + name.replace("_", "-"), str(root / "run" / name)]
    return argv


@contextlib.contextmanager
def long_sampler(steps: int):
    """While open, the long path's sampler records (its logits, f32 on the
    host with the unsampleable ids' float32-min set to 0; the ids it picks)
    for its first ``steps`` calls: the prefill's, then the decode steps'."""
    from vnsum_tpu_torch.backend import long_context as lc

    seen: list = []
    sample = lc.sample_logits_rows

    def spy(rows, *args, **kw):
        ids = sample(rows, *args, **kw)
        if len(seen) < steps:
            seen.append((rows.float().masked_fill(rows <= -1e30, 0.0).cpu(), ids.cpu()))
        return ids

    lc.sample_logits_rows = spy
    try:
        yield seen
    finally:
        lc.sample_logits_rows = sample


def long_mesh_rank(rank: int, init_file: str, root: str) -> None:
    """9h's rank ``rank`` of 2, a process of its own on card 0, its output
    in its own log: the gloo group, init_distributed accepting it, then,
    once the parent's "go" file appears, the CLI (registry_depth applied
    here: the parent's patch does not reach a child process) with the
    sampler's logits and the launches read, rank 1's writes watched; then
    the planted fault on the backend the CLI built, over the prompts'
    first LONG_MESH_FAULT_BYTES bytes at 2 new tokens. Saves what it saw;
    a failure is saved as its traceback."""
    import datetime
    import traceback

    root_p = Path(root)
    log_f = open(root_p / f"rank{rank}.log", "w", buffering=1)
    os.dup2(log_f.fileno(), 1)
    os.dup2(log_f.fileno(), 2)
    sys.stdout = sys.stderr = log_f

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    out: dict = {}
    dist.init_process_group("gloo", init_method=f"file://{init_file}", world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=LONG_MESH_JOIN_S))
    try:
        from vnsum_tpu_torch.backend import long_context as lc
        from vnsum_tpu_torch.parallel import init_distributed
        from vnsum_tpu_torch.pipeline import cli
        from vnsum_tpu_torch.pipeline import runner as pr
        from vnsum_tpu_torch.testing.writes import WriteWatch

        out["accepted"] = init_distributed(device="cuda")
        time_evaluation()
        watch = WriteWatch(str(root_p / "run")) if rank else None
        t0 = time.perf_counter()
        while not (root_p / "go").exists():
            if time.perf_counter() - t0 > 2 * LONG_MESH_JOIN_S:
                raise TimeoutError("the parent never started phase 9h")
            time.sleep(0.05)
        out["waited"] = time.perf_counter() - t0
        runners, calls = [], []
        run, generate = pr.PipelineRunner.run, lc.TorchLongContextBackend.generate

        def run_spy(self):
            runners.append(self)
            return run(self)

        def generate_spy(self, prompts, **kw):
            calls.append((self, list(prompts)))
            return generate(self, prompts, **kw)

        pr.PipelineRunner.run = run_spy
        lc.TorchLongContextBackend.generate = generate_spy
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with registry_depth(long_mesh_cut, "llama3.2:3b"), \
                long_sampler(LONG_MESH_GATE_STEPS + 1) as seen:
            if watch:
                watch.on = True
            out["rc"] = cli.main(long_mesh_argv(root_p))
            if watch:
                watch.on = False
        out["wall"] = time.perf_counter() - t0
        out["launches"], out["eval_seconds"] = read_launches(), dict(EVAL_SECONDS)
        runner, (backend, prompts) = runners[-1], calls[-1]
        st = backend.stats
        out.update(
            failures=runner.failures, primary=runner.primary, mesh=dict(runner.mesh.shape),
            coords=dict(runner.mesh.coords), calls=len(calls), prompts=prompts,
            forwards=st.prefill_forwards, steps=st.decode_steps, captured=st.captured_steps,
            by_bucket=dict(st.by_bucket), prompt_tokens=st.prompt_tokens,
            prefill_s=st.phase_seconds.get("prefill", 0.0),
            decode_s=st.phase_seconds.get("decode", 0.0),
            peak_gb=torch.cuda.max_memory_allocated() / 1e9, logits=seen,
            writes=None if watch is None else list(watch.seen))
        # the planted fault: rank 1 leaves out its share of every layer's
        # seq sum of o (index 1 of the two sums a layer: l, then o)
        if rank == 1:
            backend.group = SkipOneAllReduce(backend.group, 1, 2)
        with long_sampler(2) as seen:
            backend.generate(long_mesh_fault_prompts(prompts), max_new_tokens=2)
        out["fault_logits"] = seen
    except Exception:
        out["error"] = traceback.format_exc()
    finally:
        torch.save(out, root_p / f"rank{rank}.pt")
        dist.destroy_process_group()


def start_long_mesh() -> dict:
    """9h's two ranks, spawned at phase 9f's start so that they start up
    (the interpreter, torch, the card's context, the group) while 9f runs;
    they wait for phase 9h's "go" file. Path (c)'s corpus goes under a
    temporary root they share."""
    import multiprocessing

    root = Path(tempfile.mkdtemp(prefix="vnsum_long_mesh_"))
    long_corpus(root / "corpus")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=long_mesh_rank, args=(r, str(root / "rendezvous"), str(root)),
                         daemon=True) for r in range(2)]
    for p in procs:
        p.start()
    return {"root": root, "procs": procs, "t0": time.perf_counter()}


def stop_ranks(started: dict) -> None:
    """Stops a phase's rank processes and removes their shared root."""
    for p in started["procs"]:
        if p.is_alive():
            p.kill()
            p.join(10)
    shutil.rmtree(started["root"], ignore_errors=True)


def phase_long_mesh(torch, started: dict) -> dict:
    """Phase 9h: "go" to the two ranks (start_long_mesh), then, while they
    run, the one-rank reference on the same weights and prompts (eager, so
    that the sampler sees every step; and on the planted fault's prompts),
    then the gates: (i) init_distributed accepted
    the gloo group and the mesh reads {data 1, model 1, seq 2}; (ii) the
    prefill's and the first LONG_MESH_GATE_STEPS decode steps' logits
    within LONG_MESH_RTOL of the reference's, the two ranks' bits equal;
    (iii) the planted fault past it; (iv) rank 0 wrote both summaries, one
    results JSON and one log, rank 1 nothing; (v) each rank's K2p launches
    exactly LONG_MESH_LAYERS x its decode steps, K1, K2, K3 and the GEMV
    none (the ring prefill is plain torch). Greedy agreement, each rank's
    prefill and decode seconds and peak memory logged, not gated. Stops
    both ranks whatever happens. Returns the launches, summed over the
    ranks."""
    from vnsum_tpu_torch.backend.long_context import TorchLongContextBackend
    from vnsum_tpu_torch.strategies import TruncatedStrategy
    from vnsum_tpu_torch.strategies.prompts import TRUNCATED

    root, procs = started["root"], started["procs"]
    try:
        docs = sorted((root / "corpus/doc").glob("*.txt"))
        one = TorchLongContextBackend(
            model_config=long_mesh_cut(), batch_size=2, max_new_tokens=LONG_MESH_NEW,
            max_total_tokens=LONG_MESH_BUCKET, cuda_graphs=False, device="cuda")
        strategy = TruncatedStrategy(one, max_context=LONG_MESH_CONTEXT,
                                     max_new_tokens=LONG_MESH_NEW)
        prompts = [TRUNCATED.format(text=strategy._truncate(d.read_text(encoding="utf-8")))
                   for d in docs]
        (root / "go").write_text("go")
        t_go = time.perf_counter()
        with long_sampler(LONG_MESH_GATE_STEPS + 1) as want:
            want_texts = one.generate(prompts)
        ref_s = time.perf_counter() - t_go
        ref = dict(one.stats.phase_seconds, steps=one.stats.decode_steps)
        with long_sampler(2) as want_fault:
            one.generate(long_mesh_fault_prompts(prompts), max_new_tokens=2)
        del one
        torch.cuda.empty_cache()
        for p in procs:
            p.join(max(LONG_MESH_JOIN_S - (time.perf_counter() - t_go), 1.0))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        if hung:
            raise AssertionError(f"long mesh: ranks {hung} did not finish within "
                                 f"{LONG_MESH_JOIN_S} s")
        wall = time.perf_counter() - t_go
        ranks = []
        for r in range(2):
            path = root / f"rank{r}.pt"
            if not path.is_file():
                raise AssertionError(f"long mesh: rank {r} saved nothing (exit "
                                     f"{procs[r].exitcode}):\n"
                                     + (root / f"rank{r}.log").read_text()[-4000:])
            ranks.append(torch.load(path, weights_only=False))
        for r, res in enumerate(ranks):
            if "error" in res:
                raise AssertionError(f"long mesh rank {r}:\n{res['error']}\n"
                                     + (root / f"rank{r}.log").read_text()[-4000:])
        total = dict.fromkeys(COUNTERS, 0)
        for r, res in enumerate(ranks):
            # (i)
            if (not res["accepted"] or res["mesh"] != {"seq": 2, "data": 1, "model": 1}
                    or res["coords"]["seq"] != r or res["primary"] != (r == 0)):
                raise AssertionError(f"long mesh rank {r}: accepted {res['accepted']}, mesh "
                                     f"{res['mesh']}, coords {res['coords']}, primary "
                                     f"{res['primary']}")
            if res["rc"] != 0 or res["failures"] or res["calls"] != 1:
                raise AssertionError(f"long mesh rank {r}: exit {res['rc']}, failures "
                                     f"{res['failures']}, {res['calls']} generate calls")
            if res["prompts"] != prompts or res["by_bucket"] != {(2, LONG_MESH_BUCKET): 1}:
                raise AssertionError(f"long mesh rank {r}: batches {res['by_bucket']}; its "
                                     "prompts equal the reference's: "
                                     f"{res['prompts'] == prompts}")
            # (v)
            need = {"partials": LONG_MESH_LAYERS * res["steps"]}
            check_exact(f"long mesh rank {r}", res["launches"], need, ("partials",))
            if res["captured"]:
                raise AssertionError(f"long mesh rank {r}: {res['captured']} steps replayed")
            for k in total:
                total[k] += res["launches"][k]
            log(f"[long mesh] rank {r}: mesh {res['mesh']}, coords {res['coords']}, CLI wall "
                f"{res['wall']:.2f}s (started up during phase 9f, waited {res['waited']:.1f}s), "
                f"prefill {res['prefill_s']:.3f}s ({res['forwards']} ring forward at "
                f"S={LONG_MESH_BUCKET}, {LONG_MESH_SHARD} slots a rank), decode "
                f"{res['decode_s']:.3f}s ({res['steps']} eager steps, "
                f"{1e3 * res['decode_s'] / max(res['steps'], 1):.1f} ms a step), prompt tokens "
                f"{res['prompt_tokens']}, peak memory {res['peak_gb']:.2f} GB")
        # (ii) and (iii)
        for (a, ia), (b, ib) in zip(ranks[0]["logits"], ranks[1]["logits"]):
            if not torch.equal(a, b) or not torch.equal(ia, ib):
                raise AssertionError("long mesh: the two ranks' logits or picks differ")
        sound = logits_measure(torch, ranks[0]["logits"], want, 2)
        fault = logits_measure(torch, ranks[1]["fault_logits"], want_fault, 2)
        worst, planted = max(m for m, _ in sound), max(m for m, _ in fault)
        log(f"[long mesh] gate, seq = 2 against one rank (reference {ref_s:.2f}s, run while "
            f"the ranks ran: prefill "
            f"{ref.get('prefill', 0.0):.3f}s through K1, decode "
            f"{ref.get('decode', 0.0):.3f}s, {ref['steps']} eager steps): per "
            "call (the prefill, then decode steps: rows compared) "
            + ", ".join(f"{m:.3e} ({n})" for m, n in sound)
            + "; the planted fault (rank 1 keeps its own K2p partial of o on every layer; "
            f"the prompts' first {LONG_MESH_FAULT_BYTES} bytes) "
            + ", ".join(f"{m:.3e} ({n})" for m, n in fault) + f"; limit {LONG_MESH_RTOL}")
        if (worst > LONG_MESH_RTOL or planted <= LONG_MESH_RTOL
                or len(sound) != LONG_MESH_GATE_STEPS + 1):
            raise AssertionError(f"long mesh: gate {worst:.3e}, planted fault {planted:.3e}, "
                                 f"limit {LONG_MESH_RTOL}")
        # (iv)
        run = root / "run"
        if ranks[1]["writes"]:
            raise AssertionError(f"long mesh: rank 1 wrote {ranks[1]['writes']}")
        results = sorted((run / "results_dir").glob("pipeline_results_*.json"))
        logs = sorted((run / "logs_dir").glob("*"))
        if len(results) != 1 or len(logs) != 1:
            raise AssertionError(f"long mesh: results JSON {results}, logs {logs}")
        res0 = json.loads(results[0].read_text(encoding="utf-8"))["results"]
        EVAL_SECONDS.update(ranks[0]["eval_seconds"])  # rank 0 ran the evaluation
        _, summaries = check_run(res0, docs, run / "generated_summaries_dir",
                                 approach="truncated")
        spans = {k: v["count"] for k, v in res0["tracing"]["spans"].items()}
        if spans != {**RUNNER_SPANS, "evaluate/rouge": len(docs)}:
            raise AssertionError(f"long mesh: results.tracing spans {spans}")
        texts = [summaries[d.name] for d in docs]
        log(f"[long mesh] rank 0 wrote {len(summaries)} summaries, 1 results JSON, 1 log; rank "
            f"1 wrote nothing (audit hook); rouge "
            f"{json.dumps(res0['evaluation']['llama3.2:3b']['rouge_scores'])}")
        log(f"[long mesh] greedy agreement with one rank (not gated: bf16 near-ties): "
            f"{agreement(texts, want_texts)}; wall "
            f"{wall:.1f}s from go to both ranks joined")
        log("[launches] long mesh, both ranks: " + ", ".join(f"{k} {v}" for k, v in total.items()))
        return total
    finally:
        stop_ranks(started)


# -- phase 9i -----------------------------------------------------------------

# phase 9i (ROADMAP A12a, A12b): training on the card. (a) one card,
# Llama-3.2-3B at full width and TRAIN_LAYERS of its 28 layers, bf16, remat
# on, a TRAIN_BATCH batch drawn from a seeded numpy generator; (b) the full
# 28 layers, not gated; (c) phase 9g (c)'s two ranks' model = 2 step on the
# same weights and batch, and then (d) ZeRO-3 over fsdp = 2 and (e) the
# ring over seq = 2 in the same ranks, compared here with (a)'s one-rank
# gradients.
TRAIN_LAYERS = MESH_TP_LAYERS  # (c)'s ranks' depth: (a)'s gradients are (c)'s reference
TRAIN_BATCH = (2, 1024)
TRAIN_SEED = 29
TRAIN_LR = 1e-4
TRAIN_STEPS = 8
TRAIN_SAVE_AT = 2
# (a)(i): forward_train's logits against the cached forward through K1 on
# the same tokens, as max |train - K1| over the largest |K1| logit, the
# measure and limit of 9g and 9h: the same bf16 weights, attention dense
# (p rounded to bf16 against the row's max) against K1's tiles
TRAIN_LOGITS_RTOL = 0.1
# (a)(ii) and (c): a gradient against its reference as ||g - ref|| / ||ref||
# (relative L2). (ii) holds the bf16 model's every leaf to an f32 copy's
# (bf16 rounding of each activation and product, ~2^-9 relative, summed
# over 4 layers); (c) the model = 2 ranks' to (a)'s one-rank bf16 ones
# (partial products rounded to bf16 before each sum)
TRAIN_GRAD_RTOL = 0.1
# (c)'s leaves: a head-sharded and a hidden-sharded weight, the
# vocab-sharded embedding (tied: the head's gradient too), a replicated norm
TRAIN_TP_LEAVES = ("layers/wq", "layers/w_down", "embed", "layers/attn_norm")
# the planted fault (rank 1's f skips its backward all-reduce) must exceed
# TRAIN_GRAD_RTOL on these
TRAIN_FAULT_LEAVES = ("layers/wq", "layers/attn_norm")
# (b): the full depth, B x S, steps
TRAIN_FULL_BATCH = (2, 2048)
TRAIN_FULL_STEPS = 3
# (c): how long 9g (c)'s ranks wait for phase 9i's "go" (phase 9h runs
# meanwhile), and how long 9i waits for their step after it (and for (d)
# and (e) after (b))
TRAIN_GO_S = 600.0
TRAIN_RANKS_S = 240.0
# (d) and (e), run in 9g (c)'s ranks after (c): each arm's mesh over the
# same two ranks and its option
TRAIN_ARMS = {"d": ({"fsdp": 2}, {"fsdp": True}),
              "e": ({"seq": 2}, {"context_parallel": True})}
# (d) and (e): the loss against (a)'s, relative
TRAIN_ARM_LOSS_RTOL = 1e-3
# the planted faults must exceed TRAIN_GRAD_RTOL on these: (d) rank 1's
# gather_layer keeps its own share of its layers' gradient (the layer
# leaves), (e) the backward ring leaves each block's dk/dv one shift short
# of home (wk and wv directly, wq through the residual stream below)
TRAIN_ARM_FAULT_LEAVES = {"d": ("layers/wq", "layers/attn_norm"), "e": ("layers/wq",)}


def train_batch(shape=TRAIN_BATCH):
    """Token ids [B, S] over Llama-3's vocabulary from a seeded generator."""
    import numpy as np

    return np.random.default_rng(TRAIN_SEED).integers(0, 128_256, size=shape, dtype=np.int32)


def rel_l2(a, b) -> float:
    """||a - b|| / ||b|| in f32."""
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def rel_l2_by_layer(key: str, a, b) -> float:
    """rel_l2, for a stacked layer leaf the worst of its layers'."""
    if not key.startswith("layers/"):
        return rel_l2(a, b)
    return max(rel_l2(x, y) for x, y in zip(a, b))


def mm_dtype_derivative(torch) -> str:
    """Whether ``aten::mm.dtype`` (``torch.mm(..., out_dtype=)``, the bf16
    head's product) has a derivative in this torch, on the card."""
    x = torch.randn(8, 8, dtype=torch.bfloat16, device="cuda", requires_grad=True)
    try:
        torch.mm(x, x.detach(), out_dtype=torch.float32).sum().backward()
    except (RuntimeError, NotImplementedError) as e:
        return f"absent ({type(e).__name__}: {str(e).splitlines()[0][:160]})"
    return "present"


def layer_bytes(trainer) -> dict:
    """A trainer's bytes of stacked-layer parameters and of their moments."""
    ps = [p for path, p, _ in trainer.leaves() if path[0] == "layers"]
    moments = [trainer.optimizer.state[p][m] for p in ps for m in ("mu", "nu")]
    return {"params": sum(p.numel() * p.element_size() for p in ps),
            "moments": sum(m.numel() * m.element_size() for m in moments)}


def train_rank(torch, rank: int, mesh, go: Path) -> dict:
    """9i (c) in 9g (c)'s rank ``rank``, after its inference gates: a Trainer
    over its model = 2 mesh on (a)'s weights (Llama-3.2-3B at
    MESH_TP_LAYERS from seed 0) and batch, built while phase 9h runs;
    then, at phase 9i's ``go`` file, one backward with the planted fault
    (rank 1's f, ``copy_to_group``, skips its backward all-reduce, issued
    on a copy so that the ranks stay in step), the local gradients of
    TRAIN_FAULT_LEAVES read, and one Trainer.step, sound, its loss and the
    local gradients of TRAIN_TP_LEAVES read as they accumulate. The launch
    counters must stay 0. The whole model stays in the result ("whole")
    for (d) and (e)."""
    from vnsum_tpu_torch.models import llama32_3b
    from vnsum_tpu_torch.models.llama import init_model
    from vnsum_tpu_torch.parallel import autograd
    from vnsum_tpu_torch.train import TrainConfig, Trainer, lm_loss

    cfg = llama32_3b(n_layers=MESH_TP_LAYERS)
    seconds = {}
    t0 = time.perf_counter()
    whole = init_model(cfg, 0, "cuda")
    torch.cuda.synchronize()
    seconds["init"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tr = Trainer(cfg, mesh, TrainConfig(learning_rate=TRAIN_LR, remat=True), params=whole)
    torch.cuda.synchronize()
    seconds["build"] = time.perf_counter() - t0
    tokens = torch.from_numpy(train_batch()).to("cuda")
    leaves = {"/".join(path): p for path, p, _ in tr.leaves() if "/".join(path) in TRAIN_TP_LEAVES}
    t0 = time.perf_counter()
    while not go.exists():
        if time.perf_counter() - t0 > TRAIN_GO_S:
            raise TimeoutError("the parent never started phase 9i")
        time.sleep(0.05)
    seconds["waited"] = time.perf_counter() - t0
    reset_launches()
    real = autograd._CopyToGroup.backward

    def skipped(ctx, grad):
        autograd._summed(grad, ctx.group)  # issued and dropped
        return grad, None

    if rank == 1:
        autograd._CopyToGroup.backward = staticmethod(skipped)
    t0 = time.perf_counter()
    try:
        lm_loss(tr.model, tokens, torch.ones_like(tokens, dtype=torch.bool), remat=True).backward()
    finally:
        autograd._CopyToGroup.backward = staticmethod(real)
    fault = {k: leaves[k].grad.cpu() for k in TRAIN_FAULT_LEAVES}
    seconds["fault"] = time.perf_counter() - t0
    tr.optimizer.zero_grad(set_to_none=True)
    grads = {}
    hooks = [p.register_post_accumulate_grad_hook(
        lambda p, k=k: grads.__setitem__(k, p.grad.cpu())) for k, p in leaves.items()]
    t0 = time.perf_counter()
    loss = tr.step(tokens)
    seconds["step"] = time.perf_counter() - t0
    for h in hooks:
        h.remove()
    return {"loss": loss, "grads": grads, "fault_grads": fault, "launches": read_launches(),
            "seconds": seconds, "shapes": {k: tuple(p.shape) for k, p in leaves.items()},
            "whole": whole}


@contextlib.contextmanager
def planted_arm_fault(arm: str, rank: int):
    """(d): rank 1's gather_layer backward issues its reduce (so that the
    ranks stay in step) and keeps its own share where it owns the layer;
    (e): both ranks' backward ring skips the dk/dv shift home."""
    import torch

    from vnsum_tpu_torch.parallel import autograd, ring

    real_gather, real_home = autograd._GatherLayer.backward, ring._home

    def kept(ctx, grad):
        ctx.group.reduce_sum(grad.clone(memory_format=torch.contiguous_format), ctx.owner)
        return (grad if ctx.group.rank == ctx.owner else None), None, None

    if arm == "d" and rank == 1:
        autograd._GatherLayer.backward = staticmethod(kept)
    if arm == "e":
        ring._home = lambda group, dk, dv: (dk, dv)
    try:
        yield
    finally:
        autograd._GatherLayer.backward, ring._home = staticmethod(real_gather), real_home


def train_rank_arm(torch, rank: int, arm: str, whole, tokens) -> dict:
    """9i (d) or (e) in 9g (c)'s rank ``rank``, after (c): a Trainer with the
    arm's option over a second mesh of the same two ranks, on (a)'s weights
    (``whole``) and batch. One backward with the planted fault
    (``lm_loss`` alone: this rank's share of the fault leaves' gradients),
    then the sound step: ``Trainer.backward`` (the gradients of
    TRAIN_TP_LEAVES read as the update reads them), the update. Reads each
    rank's bytes of layer parameters and moments, the seconds and the
    launch counters, which must stay 0."""
    from vnsum_tpu_torch.parallel import make_mesh
    from vnsum_tpu_torch.parallel.sharding import batch_rows
    from vnsum_tpu_torch.train import TrainConfig, Trainer, lm_loss

    shape, option = TRAIN_ARMS[arm]
    seconds = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mesh = make_mesh(shape, device=tokens.device.type)
    tr = Trainer(whole.cfg, mesh, TrainConfig(learning_rate=TRAIN_LR, remat=True, **option),
                 params=whole)
    torch.cuda.synchronize()
    seconds["build"] = time.perf_counter() - t0
    held = layer_bytes(tr)
    leaves = {"/".join(path): p for path, p, _ in tr.leaves()}
    reset_launches()
    rows = (tr.data, tr.fsdp)
    lo, hi = batch_rows(rows, tokens.shape[0])
    t0 = time.perf_counter()
    with planted_arm_fault(arm, rank):
        lm_loss(tr.model, tokens[lo:hi], torch.ones_like(tokens[lo:hi], dtype=torch.bool),
                remat=True, data=rows, seq=tr.seq).backward()
    fault = {k: leaves[k].grad.cpu() for k in TRAIN_ARM_FAULT_LEAVES[arm]}
    tr.optimizer.zero_grad(set_to_none=True)
    seconds["fault"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    loss = tr.backward(tokens)
    grads = {k: leaves[k].grad.cpu() for k in TRAIN_TP_LEAVES}
    tr.optimizer.step()
    tr.optimizer.zero_grad(set_to_none=True)
    loss = float(loss.detach())
    seconds["step"] = time.perf_counter() - t0
    out = {"loss": loss, "grads": grads, "fault_grads": fault, "held": held,
           "launches": read_launches(), "seconds": seconds, "coords": dict(mesh.coords),
           "peak": torch.cuda.max_memory_allocated()}
    del tr
    torch.cuda.empty_cache()
    return out


def train_one_card(torch, cfg, tokens) -> tuple[dict, float, dict]:
    """9i (a) on one card. Returns ((a)'s bf16 gradients of TRAIN_TP_LEAVES
    at the initial weights, the loss there: (c)'s, (d)'s and (e)'s
    reference; and its bytes of layer parameters and moments)."""
    import dataclasses

    from vnsum_tpu_torch.models.llama import (
        LlamaModel, forward_train, init_kv_cache, prefill_positions,
    )
    from vnsum_tpu_torch.ops.flash_attention import flash_prefill_attention
    from vnsum_tpu_torch.parallel import make_mesh
    from vnsum_tpu_torch.train import TrainCheckpointer, TrainConfig, Trainer, lm_loss
    from vnsum_tpu_torch.train.trainer import model_leaves

    mesh = make_mesh({}, device="cuda")
    tc = TrainConfig(learning_rate=TRAIN_LR, remat=True)
    B, S = tokens.shape
    ones = torch.ones_like(tokens, dtype=torch.bool)
    t0 = time.perf_counter()
    a = Trainer(cfg, mesh, tc, seed=0)
    torch.cuda.synchronize()
    log(f"[train] (a) Trainer: Llama-3.2-3B at {cfg.n_layers} of 28 layers, bf16, remat, "
        f"B={B} S={S}, built in {time.perf_counter() - t0:.2f}s")

    # (i) the training forward against the cached forward through K1
    pads = torch.zeros(B, dtype=torch.int32, device="cuda")
    reset_launches()
    with torch.no_grad():
        cache = init_kv_cache(cfg, B, S, device="cuda")
        want = a.model(tokens, prefill_positions(pads, S), cache, 0, None,
                       stacked_attention_fn=lambda q, c, li: flash_prefill_attention(
                           q, c, li, pads, cfg.q_per_kv, 0, 0))
        got = forward_train(a.model, tokens)
    k1 = read_launches()
    err = float((got - want).abs().max() / want.abs().max())
    del cache, want, got
    log(f"[train] (a)(i) forward_train's logits against the cached forward through K1 "
        f"({k1['prefill']} K1 launches): {err:.3e} of the largest logit; limit "
        f"{TRAIN_LOGITS_RTOL}")
    if not err <= TRAIN_LOGITS_RTOL or k1 != dict(dict.fromkeys(COUNTERS, 0),
                                                   prefill=cfg.n_layers):
        raise AssertionError(f"train (a)(i): {err:.3e}, launches {k1}")

    # (ii) every leaf's bf16 gradient against an f32 copy's
    t0 = time.perf_counter()
    loss16 = lm_loss(a.model, tokens, ones)
    loss16.backward()
    g16 = {"/".join(path): p.grad for path, p, _ in a.leaves()}
    a.optimizer.zero_grad(set_to_none=True)
    tree = {k: v.float() for k, v in a.params.items() if k != "layers"}
    tree["layers"] = {k: v.float() for k, v in a.params["layers"].items()}
    f32 = LlamaModel(dataclasses.replace(cfg, dtype=torch.float32), tree, trainable=True)
    del tree
    loss32 = lm_loss(f32, tokens, ones)
    loss32.backward()
    errs = {"/".join(path): rel_l2(g16["/".join(path)], p.grad) for path, p in model_leaves(f32)}
    worst = max(errs, key=errs.get)
    ref = {k: g16[k] for k in TRAIN_TP_LEAVES}
    ref_loss = float(loss16.detach())
    held = layer_bytes(a)
    del f32, g16, loss32
    torch.cuda.empty_cache()
    log(f"[train] (a)(ii) bf16 gradients against an f32 copy's (relative L2), "
        f"{time.perf_counter() - t0:.2f}s: "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f"; worst {worst} {errs[worst]:.3e}, limit {TRAIN_GRAD_RTOL}; loss bf16 {ref_loss:.6f}")
    if not errs[worst] <= TRAIN_GRAD_RTOL:
        raise AssertionError(f"train (a)(ii): {worst} {errs[worst]:.3e}")

    # (iii) TRAIN_STEPS steps on the batch, (iv) a save after TRAIN_SAVE_AT
    reset_launches()
    losses, walls = [], []

    def step(t):
        t0 = time.perf_counter()
        loss = t.step(tokens)
        walls.append(time.perf_counter() - t0)
        return loss

    for _ in range(TRAIN_SAVE_AT):
        losses.append(step(a))
    root = tempfile.mkdtemp(prefix="vnsum_train_")
    try:
        ckpt = TrainCheckpointer(root)
        t0 = time.perf_counter()
        ckpt.save(a)
        saved_s = time.perf_counter() - t0
        b = Trainer(cfg, mesh, tc, seed=1)
        differed = not torch.equal(b.params["layers"]["wq"], a.params["layers"]["wq"])
        t0 = time.perf_counter()
        ckpt.restore(b)
        restored_s = time.perf_counter() - t0
        same = b.step_count == a.step_count and all(
            torch.equal(p, q) and torch.equal(a.optimizer.state[p]["mu"],
                                                     b.optimizer.state[q]["mu"])
            and torch.equal(a.optimizer.state[p]["nu"], b.optimizer.state[q]["nu"])
            for (_, p, _), (_, q, _) in zip(a.leaves(), b.leaves()))
        losses.append(step(a))
        resumed = b.step(tokens)
        del b
    finally:
        shutil.rmtree(root, ignore_errors=True)
    while len(losses) < TRAIN_STEPS:
        losses.append(step(a))
    launches = read_launches()
    del a
    torch.cuda.empty_cache()
    log(f"[train] (a)(iii) {TRAIN_STEPS} steps at lr {TRAIN_LR}: losses "
        + ", ".join(f"{x:.6f}" for x in losses)
        + f"; step s " + ", ".join(f"{w:.3f}" for w in walls)
        + f" ({B * S / statistics.median(walls[1:]):.0f} tokens/s at the median after the first)")
    log(f"[train] (a)(iv) save after step {TRAIN_SAVE_AT} {saved_s:.2f}s, restore into a "
        f"seed-1 trainer {restored_s:.2f}s (its weights differed before: {differed}); every "
        f"parameter and moment bit-equal: {same}; step {TRAIN_SAVE_AT + 1} loss "
        f"{losses[TRAIN_SAVE_AT]!r} saved, {resumed!r} restored")
    log("[launches] train (a) steps: " + ", ".join(f"{k} {v}" for k, v in launches.items()))
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"train (a)(iii): losses {losses}")
    if not (differed and same and resumed == losses[TRAIN_SAVE_AT]):
        raise AssertionError(f"train (a)(iv): differed {differed}, equal {same}, "
                             f"losses {losses[TRAIN_SAVE_AT]!r} / {resumed!r}")
    if any(launches.values()):
        raise AssertionError(f"train (a): the steps launched kernels: {launches}")
    return ref, ref_loss, held


def train_two_ranks(torch, ranks: list, ref: dict, ref_loss: float) -> None:
    """9i (c): phase 9g (c)'s two ranks' model = 2 step against (a)'s
    one-rank gradients and loss at the same weights: each sharded leaf's
    gathered shards and each rank's replicated leaf within
    TRAIN_GRAD_RTOL, the planted fault past it, no kernel launched."""
    from vnsum_tpu_torch.parallel.sharding import param_specs

    specs = param_specs(True)

    def whole(key: str, field: str, rank: int):
        """The leaf's gradient on the card: the ranks' shards in order, or
        rank ``rank``'s replicated one."""
        path = key.split("/")
        spec = specs[path[0]] if len(path) == 1 else specs[path[0]][path[1]]
        if "model" not in spec:
            return ranks[rank][field][key].to(ref[key].device)
        return torch.cat([r[field][key] for r in ranks], dim=spec.index("model")).to(ref[key].device)

    sound = {k: max(rel_l2(whole(k, "grads", r), ref[k]) for r in range(2))
             for k in TRAIN_TP_LEAVES}
    fault = {k: max(rel_l2(whole(k, "fault_grads", r), ref[k]) for r in range(2))
             for k in TRAIN_FAULT_LEAVES}
    loss_err = abs(ranks[0]["loss"] - ref_loss) / abs(ref_loss)
    log(f"[train] (c) model = 2 over 9g (c)'s gloo ranks against (a) at one rank (relative L2, "
        "gathered shards): " + ", ".join(f"{k} {v:.3e}" for k, v in sound.items())
        + f"; loss {ranks[0]['loss']:.6f} against {ref_loss:.6f} ({loss_err:.3e}); the planted "
        "fault (rank 1's f skips its backward all-reduce): "
        + ", ".join(f"{k} {v:.3e}" for k, v in fault.items())
        + f"; limit {TRAIN_GRAD_RTOL}; each rank's seconds "
        + " / ".join(", ".join(f"{k} {v:.2f}" for k, v in r["seconds"].items()) for r in ranks)
        + "; local shapes "
        + ", ".join(f"{k} {v}" for k, v in ranks[0]["shapes"].items()))
    if ranks[0]["loss"] != ranks[1]["loss"]:
        raise AssertionError(f"train (c): the ranks' losses differ: {ranks[0]['loss']!r}, "
                             f"{ranks[1]['loss']!r}")
    if any(any(r["launches"].values()) for r in ranks):
        raise AssertionError(f"train (c): the ranks launched kernels: "
                             f"{[r['launches'] for r in ranks]}")
    if (max(sound.values()) > TRAIN_GRAD_RTOL or loss_err > TRAIN_GRAD_RTOL
            or min(fault.values()) <= TRAIN_GRAD_RTOL):
        raise AssertionError(f"train (c): gradients {sound}, loss {loss_err:.3e}, fault {fault}")


def train_arms(torch, ranks: list, ref: dict, ref_loss: float, held: dict) -> None:
    """9i (d) and (e): each arm's step in 9g (c)'s two ranks against (a)'s
    one-rank gradients and loss at the same weights: the gradients of
    TRAIN_TP_LEAVES within TRAIN_GRAD_RTOL, a layer leaf's every layer
    (under fsdp a layer leaf is the ranks' owned layers in order; a fault
    in one rank's layers is diluted in the whole leaf's norm), the loss
    within TRAIN_ARM_LOSS_RTOL,
    the two ranks' losses equal, the planted fault past the limit on
    TRAIN_ARM_FAULT_LEAVES, no kernel launched; under fsdp each rank holds
    half of (a)'s bytes of layer parameters and of moments."""
    for arm, (shape, option) in TRAIN_ARMS.items():
        res = [r[arm] for r in ranks]
        fsdp = bool(option.get("fsdp"))

        def whole(key: str, field: str, rank: int):
            """The leaf's gradient on the card: under fsdp a layer leaf's
            owned layers in the fsdp ranks' order; else rank ``rank``'s."""
            if fsdp and key.startswith("layers/"):
                parts = sorted(res, key=lambda r: r["coords"]["fsdp"])
                return torch.cat([r[field][key] for r in parts]).to(ref[key].device)
            return res[rank][field][key].to(ref[key].device)

        def fault_whole(key: str):
            """The fault leaf's gradient: the fsdp ranks' owned layers, or
            the seq ranks' local shares summed."""
            if fsdp:
                return whole(key, "fault_grads", 0)
            return sum(r["fault_grads"][key].float() for r in res).to(ref[key].device)

        sound = {k: max(rel_l2_by_layer(k, whole(k, "grads", r), ref[k]) for r in range(2))
                 for k in TRAIN_TP_LEAVES}
        fault = {k: rel_l2_by_layer(k, fault_whole(k), ref[k])
                 for k in TRAIN_ARM_FAULT_LEAVES[arm]}
        loss_err = abs(res[0]["loss"] - ref_loss) / abs(ref_loss)
        what = ("rank 1's gather_layer keeps its own share of its layers' gradient" if fsdp
                else "the backward ring leaves dk/dv one shift short of home")
        log(f"[train] ({arm}) {shape} over 9g (c)'s gloo ranks against (a) at one rank "
            "(relative L2, a layer leaf's worst layer): " + ", ".join(f"{k} {v:.3e}" for k, v in sound.items())
            + f"; loss {res[0]['loss']:.6f} against {ref_loss:.6f} ({loss_err:.3e}, limit "
            f"{TRAIN_ARM_LOSS_RTOL}); the planted fault ({what}): "
            + ", ".join(f"{k} {v:.3e}" for k, v in fault.items())
            + f"; limit {TRAIN_GRAD_RTOL}; each rank's bytes of layer parameters / moments "
            + " / ".join(f"{r['held']['params']:,} / {r['held']['moments']:,}" for r in res)
            + f" against (a)'s {held['params']:,} / {held['moments']:,}; each rank's seconds "
            + " / ".join(", ".join(f"{k} {v:.2f}" for k, v in r["seconds"].items()) for r in res)
            + "; peak " + " / ".join(f"{r['peak'] / 1e9:.2f}" for r in res) + " GB")
        if res[0]["loss"] != res[1]["loss"]:
            raise AssertionError(f"train ({arm}): the ranks' losses differ: {res[0]['loss']!r}, "
                                 f"{res[1]['loss']!r}")
        if any(any(r["launches"].values()) for r in res):
            raise AssertionError(f"train ({arm}): the ranks launched kernels: "
                                 f"{[r['launches'] for r in res]}")
        if fsdp and any(2 * r["held"]["params"] != held["params"]
                        or 2 * r["held"]["moments"] != held["moments"] for r in res):
            raise AssertionError(f"train ({arm}): a rank holds {[r['held'] for r in res]}, not "
                                 f"half of (a)'s {held}")
        if (max(sound.values()) > TRAIN_GRAD_RTOL or loss_err > TRAIN_ARM_LOSS_RTOL
                or min(fault.values()) <= TRAIN_GRAD_RTOL):
            raise AssertionError(f"train ({arm}): gradients {sound}, loss {loss_err:.3e}, "
                                 f"fault {fault}")


def train_full_depth(torch) -> None:
    """9i (b), not gated: Llama-3.2-3B at its 28 layers, TRAIN_FULL_STEPS
    steps at TRAIN_FULL_BATCH: step seconds, tokens/s, peak memory."""
    from vnsum_tpu_torch.models import llama32_3b
    from vnsum_tpu_torch.parallel import make_mesh
    from vnsum_tpu_torch.train import TrainConfig, Trainer

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    full = Trainer(llama32_3b(), make_mesh({}, device="cuda"),
                   TrainConfig(learning_rate=TRAIN_LR, remat=True), seed=0)
    torch.cuda.synchronize()
    built, built_peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated()
    tokens = torch.from_numpy(train_batch(TRAIN_FULL_BATCH)).to("cuda")
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    for _ in range(TRAIN_FULL_STEPS):
        t0 = time.perf_counter()
        losses.append(full.step(tokens))
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    del full
    torch.cuda.empty_cache()
    B, S = TRAIN_FULL_BATCH
    log(f"[train] (b) Llama-3.2-3B, 28 layers, bf16, remat, B={B} S={S}: built in {built:.2f}s "
        f"(peak {built_peak / 1e9:.2f} GB); step s " + ", ".join(f"{w:.3f}" for w in walls)
        + "; tokens/s " + ", ".join(f"{B * S / w:.0f}" for w in walls)
        + f"; peak over the steps {peak / 1e9:.2f} GB; losses "
        + ", ".join(f"{x:.6f}" for x in losses) + " (not gated)")


def phase_train(torch, ranks: dict) -> None:
    """Phase 9i: the probe of ``aten::mm.dtype``'s derivative; "go" to 9g
    (c)'s two ranks (phase_mesh's ``ranks``), which train while (a) runs
    here; then (c), comparing their step with (a)'s; (b), while the ranks
    run (d) and (e); then (d) and (e) against (a). Stops the ranks
    whatever happens."""
    from vnsum_tpu_torch.models import llama32_3b

    try:
        (ranks["root"] / "go").touch()
        t0 = time.perf_counter()
        log(f"[train] aten::mm.dtype derivative on the card: {mm_dtype_derivative(torch)}")
        tokens = torch.from_numpy(train_batch()).to("cuda")
        ref, ref_loss, held = train_one_card(torch, llama32_3b(n_layers=TRAIN_LAYERS), tokens)
        ta = time.perf_counter() - t0
        steps = collect(torch, ranks["procs"], [ranks["root"] / f"train{r}.pt" for r in range(2)],
                        time.perf_counter() + TRAIN_RANKS_S, "train (c)")
        for r, res in enumerate(steps):
            if "error" in res:
                raise AssertionError(f"train (c) rank {r}:\n{res['error']}")
        train_two_ranks(torch, steps, ref, ref_loss)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        train_full_depth(torch)
        tb = time.perf_counter() - t0
        arms = collect(torch, ranks["procs"], [ranks["root"] / f"arms{r}.pt" for r in range(2)],
                       time.perf_counter() + TRAIN_RANKS_S, "train (d), (e)")
        waited = time.perf_counter() - t0 - tb
    finally:
        stop_ranks(ranks)
    for r, res in enumerate(arms):
        if "error" in res or set(res) != set(TRAIN_ARMS):
            raise AssertionError(f"train (d), (e) rank {r}:\n{res.get('error', sorted(res))}")
    train_arms(torch, arms, ref, ref_loss, held)
    del ref
    torch.cuda.empty_cache()
    log(f"[train] arms: (a) {ta:.1f}s (beside (c)'s ranks), (b) {tb:.1f}s (beside (d) and (e) "
        f"in the ranks), then {waited:.1f}s waiting for (d) and (e)")


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
    byte-identical to the captured bf16 run's; then the long path's logits
    against the one-card engine's on the same weights and prompts
    (long_logits_gate). Returns the launches of the three gated runs."""
    import dataclasses

    from vnsum_tpu_torch.backend.engine import TorchBackend
    from vnsum_tpu_torch.backend.long_context import TorchLongContextBackend
    from vnsum_tpu_torch.core.config import PipelineConfig
    from vnsum_tpu_torch.models.llama import LlamaModel, init_model, llama32_3b
    from vnsum_tpu_torch.parallel import SeqGroup
    from vnsum_tpu_torch.pipeline.runner import PipelineRunner
    from vnsum_tpu_torch.strategies import TruncatedStrategy
    from vnsum_tpu_torch.strategies.prompts import TRUNCATED

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

        # the logits gate's reference: the one-card engine, its ceiling
        # raised to 40960 on the same weights, bf16 cache. Its ungated
        # generate over the same prompts (texts against the long path's)
        # went to pay for phase 9h's seconds
        big = LlamaModel(dataclasses.replace(cfg, max_seq_len=40960), {
            "embed": model.embed.data, "final_norm": model.final_norm.data,
            "layers": {n: p_.data for n, p_ in model.layers.items()}})
        engine = TorchBackend(model=big, batch_size=2, max_new_tokens=max_new,
                              quantize_kv=False, device="cuda")
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
    return wall


def check_step_wall(wall: float) -> None:
    """Phase 9f (d): the captured decode step's wall against its earlier
    runs' (CAPTURED_STEP_MS): logged in or out of that range, failed past
    CAPTURED_STEP_MARGIN times its top (the annotate ranges open none a
    replayed step)."""
    lo, hi = CAPTURED_STEP_MS
    inside = "inside" if lo <= wall <= hi else "outside"
    if wall > hi * CAPTURED_STEP_MARGIN:
        raise AssertionError(f"profile: the captured decode step took {wall:.3f} ms, past "
                             f"{CAPTURED_STEP_MARGIN} x the earlier runs' {hi} ms")
    log(f"[checks] (d) captured decode step {wall:.3f} ms, {inside} the earlier runs' "
        f"{lo}-{hi} ms (limit {hi * CAPTURED_STEP_MARGIN:.2f} ms)")


PROFILE_RANGE_NEW = 2         # step 0 eager, then one capture and one replay


def profile_ranges(torch, model) -> None:
    """Phase 9f (d): one engine generate on the map batch (B=8, S=4096,
    PROFILE_RANGE_NEW new tokens, captured decode) under torch.profiler:
    the trace holds the engine's annotate ranges generate[B=8,S=4096],
    prefill[B=8,S=4096] and decode_seg[B=8,S=4096] once each (one a group,
    none a replayed step) around its kernels, and no other range of the
    engine."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    from vnsum_tpu_torch.backend.engine import TorchBackend

    engine = TorchBackend(model=model, batch_size=8, max_new_tokens=PROFILE_RANGE_NEW,
                          device="cuda")
    prompts, _hint = map_batch(engine)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.generate(prompts)
        torch.cuda.synchronize()
    events = prof.events()
    cpu = torch.autograd.DeviceType.CPU
    # each range is a host event; the trace also draws it on the device's
    # timeline (gpu_user_annotation), once per stream it spans
    names = Counter(e.name for e in events if e.device_type == cpu)
    on_device = Counter(e.name for e in events if e.device_type != cpu)
    want = {f"{r}[B=8,S=4096]": 1 for r in ("generate", "prefill", "decode_seg")}
    got = {k: names.get(k, 0) for k in want}
    other = sorted(k for k in names if k.startswith(("spec_", "choice[")))
    if got != want or other:
        raise AssertionError(f"profile: the engine's ranges in the trace {got} (and "
                             f"{other}), expected {want}")
    kernels = sum(1 for e in events if e.device_type == torch.autograd.DeviceType.CUDA)
    log(f"[checks] (d) torch.profiler trace of one generate (B=8, S=4096, "
        f"{PROFILE_RANGE_NEW} new tokens, {engine.stats.captured_steps} replayed): host "
        f"ranges {got}, drawn on the device timeline {dict((k, on_device[k]) for k in want)}, "
        f"{kernels} device events; {time.perf_counter() - t0:.1f}s with the trace's "
        "processing")


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
            wall = profile_call(torch, name, fn, n, cfg.n_layers,
                                fn in (captured_decode, captured_int8_decode,
                                       captured_long_decode),
                                4 * cfg.n_layers + 1 if fn is captured_int8_decode else 0)
            if fn is captured_decode:
                check_step_wall(wall)
    del long, graphs
    torch.cuda.empty_cache()
    profile_ranges(torch, model)
    del model
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
    mutants = start_mutant_builds()
    try:
        errs = timed("correctness", phase_correctness, torch)
        phase_w8a8(torch)
    except BaseException:
        for p in mutants["builds"].values():
            p.kill()
            p.wait(10)
        shutil.rmtree(mutants["root"], ignore_errors=True)
        raise
    torch.cuda.empty_cache()
    timed("planted faults", phase_mutants, len(CHECKED), mutants)
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
    serve_launches, serve_resume, serve_ref = timed("serve", phase_serve, torch, backend.model)
    resume_launches += serve_resume
    # 9h's ranks start up while 9f runs (9g's own ranks start with 9g)
    long_mesh = start_long_mesh()
    try:
        checks_launches = timed("checks", phase_checks, torch, backend, prompts, oneshot)
        mesh_launches, mesh_tp_launches, train_ranks = timed("mesh", phase_mesh, torch,
                                                             backend.model, oneshot)
    except BaseException:
        stop_ranks(long_mesh)
        raise
    del backend
    # 9g (c)'s ranks build their trainers while 9h runs, then train in 9i
    try:
        long_mesh_launches = timed("long mesh", phase_long_mesh, torch, long_mesh)
    except BaseException:
        stop_ranks(train_ranks)
        raise
    timed("train", phase_train, torch, train_ranks)
    fixture_launches = timed("fixture", phase_fixture, torch)
    # the fleet's launches are its workers', counted in their processes
    timed("fleet", phase_fleet, torch, serve_ref)
    long_launches = timed("long context", phase_long_context, torch)
    launches = {k: launches[k] + int8_launches[k] + w8a8_launches[k] + weights_launches[k]
                + strategy_launches[k] + judge_launches[k] + spec_launches[k] + slot_launches[k]
                + cache_launches[k] + serve_launches[k] + checks_launches[k]
                + mesh_launches[k] + fixture_launches[k] + long_launches[k] for k in launches}
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
        elif key.endswith("_tp"):
            n = mesh_tp_launches[key[:-3]]
        elif key == "partials_shard":
            n = long_mesh_launches["partials"]
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
