#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py              # from the repository root
    python3 chip_smoke.py --profile    # also torch.profiler kernel tables
                                       # of the bf16-kv, int8-kv,
                                       # small-w8a8-dyn, beam5-prompt and
                                       # small-b1 runs

Phase 0  prints the card and its power limit, builds the CUDA kernels from
         `openai_whisper_compression_tpu_torch/csrc` (nvcc, sm_90a, one
         process per source).
Phase 1  each kernel against its plain PyTorch version on the card, at
         main-path shapes (whisper-small batch 32 for slice 1's four
         kernels, batch 96 for the int8/int4-KV kernels; the log-mel, held
         no less exact than its plain version against the float64 log-mel,
         also at the headline's batch 96 and with the f32 DFT at 32, the whole
         call beside the kernel alone and beside two bounds, over the
         filterbank's nonzeros and with it dense; the cross-KV quantizer
         also at whisper-medium's (64, 1500, 1024); for the int4,
         NF4/FP4 and HQQ dequant-matmuls, the decoder linears of the
         phase-2 run of each kind at M = batch and 3 x batch, and
         whisper-medium's at M = 64 and 256; the encoder attention at
         whisper-small batch 96 and whisper-medium batch 64, on the strided
         layout the projections leave; the cache updates with a mixed
         `start`, the fp update also at 36 rows in each type; the grouped
         cross-attention at 1, 3, 5 and 8 query slots over 384 and 1152
         rows, and at 5 slots over the beam runs' 192; the
         w8a8 matmul, dynamic and static, at whisper-small's four linears at
         M = 96 and M = 96 x 1500, bit for bit, beside quantize +
         `torch._int_mm` + epilogue and dequant + torch.matmul, with a
         decode-M call held to one kernel and an encoder-scale call's
         quantize pass timed apart (torch.profiler); the one-query cross-attention at 12 and
         36 rows over bf16, int8 and int4 K/V, also against the grouped
         kernel at one slot; the read-only self-attention bit for bit
         against the update kernels' output; the int8 matmul also at the
         headline batch's M = 96 and 288; the f32 and f16 bodies of the
         cache update, the grouped (1 and 5 slots) and the one-query
         cross-attention at the shapes of the f32 and f16 runs), with
         CUDA-event times (the one-query cross-attention and both cache
         updates and their read-only bodies also cold: rotating over copies
         of their buffers larger than the 50 MB L2, as a decode step meets
         them); the dequant-matmuls also beside dequant +
         torch.matmul (every storage trait at M = 32, 96, 288 and 1024: where
         the two cross), the encoder attention beside the time its
         exponentials alone need, the attentions over K/V in q's type beside
         `F.scaled_dot_product_attention` (a yardstick that no path of the
         port calls), and every kernel beside its bound: the larger of its
         bytes over the card's memory rate and its operations over the
         card's peak rate. Then (slice 18, `phase1_head_dims`) the attention
         kernels at head dims 16, 32 and 128 and at the RAGGED_DIMS 8, 36, 96,
         100 and 256 (the RAGGED bodies of capacities 16, 64, 128, 128 and
         256), whisper-small's width of 768 cut into 768 // Dh heads: the
         cross-KV quantizer at (32, 1500, 768) in bf16 and f32 (bit for bit),
         the encoder attention at (8, H, 1500, Dh), the grouped cross-attention
         over batch 32's rows (1 and 5 slots over bf16 K/V, 1 slot over f32,
         f16, int8 and int4), the one-query kernel over batch 3's rows in the
         same five kinds, both cache updates at pos 30 of a 64-row cache (fp in
         bf16, f32 and f16, int8 under bf16 q, each also with a mixed `start`)
         and the read-only attention bit for bit against them; one call a
         wrapper on strided or offset views (q a slice of a fused projection,
         K/V, scales and caches at offsets or as prefix views); both updates
         over a 16384-row cache; each held against its plain version, each
         launch counted, timed only where noted (the f32 grouped body at 128
         over 192 rows; `tools/torch_attention_ab.py` times the rest).
Phase 2  decode runs at full width with seeded random weights (bf16, but
         for the f32 and f16 trees), fused
         decoder qkv, `make_transcribe_fn` (bf16 DFT mel, tanh encoder
         GELU, greedy 25 tokens) on seeded synthetic 30 s waveforms:
           bf16-kv      whisper-small, int8 weights, batch 32, bf16
                        self-KV and cross-KV (slice 1);
           int8-kv      whisper-small, int8 weights, batch 96, int8 self-KV
                        and int8 cross-KV (`bench.py`'s headline decode);
           int4-ckv     the same with int4 cross-KV (one batch);
           medium-int4  whisper-medium, int4 weights, batch 64, int8
                        self-KV and cross-KV (`bench.py --presets`'
                        medium_int4_kv8 row);
           small-nf4dq, small-hqq4, small-hqq8  whisper-small, batch 32,
                        int8 self-KV and cross-KV, with the REGISTRY's
                        bnb_nf4_double_quant, hqq_int4 and hqq_int8 weights
                        (one batch each);
           small-w8a8-dyn     `pytorch_dynamic_int8` (int8 weights, int8
                        activations per row), batch 96, int8 caches, three
                        batches: every quantized linear of encoder, cross-KV,
                        prefill and steps through the w8a8 kernel;
           small-w8a8-static, small-w4a8-static, small-fp8  batch 32, one
                        batch each after a calibration pass on the card
                        (`calibrate_static` over the first batch):
                        `static_int8_act_int8` and `static_int4_act_int8`
                        through the w8a8 kernel's static body,
                        `static_fp8_act_fp8` through the fp8 branches (plain
                        torch, as in the JAX package);
           small-b1     int8 weights and caches at batch 1 (12 (batch, head)
                        rows): the one-query cross-attention's int8 body;
           small-b3-bf16, small-b3-int4ckv  batch 3 (36 rows), bf16 caches
                        and int4 cross-KV: its other two bodies;
           small-f32    `baseline_fp32` (an f32 tree, f32 caches), batch 16:
                        the decode kernels' f32 bodies and the encoder
                        attention's f32 (3xTF32 tensor-core) body;
           small-b3-f32, small-b3-f16  `baseline_fp32` and `fp16` at batch 3:
                        the one-query cross-attention's f32 and f16 bodies
                        (and the encoder attention's f16 body).
         bf16-kv, int8-kv and small-b1 run three batches with EOT suppressed, then
         the first batch again with EOT allowed and its embedding tied to
         a generated token, so that rows stop at different steps;
         medium-int4 runs three batches with EOT suppressed. Then four
         prompt-conditioned runs of whisper-small, with int8 weights but for
         the last (a 16-token prompt window, prompt lengths mixed over 4..16, 25 new
         tokens, EOT suppressed, two batches each), through
         `beam_decode` / `greedy_decode` with `prompt_tokens`:
           beam5-prompt      beam 5, int8 self-KV and cross-KV, batch 16;
           greedy-prompt-ts  bf16 caches, batch 32, timestamp rules on;
           beam5-int4ckv     beam 5, int8 self-KV, int4 cross-KV, batch 16;
           small-f16-beam5   `fp16` (an f16 tree, f16 caches), beam 5, batch 8.
         Every launch count is set to 0 before a run and read after it:
         each kernel of the run's path must have launched (every attention
         kernel exactly as often as the path calls it: the encoder attention
         layers x batches times, the cache update layers x steps, the
         cross-attention layers x (steps + prefill launches)), and no
         other. The beam runs' output is checked against all five beams
         rescored by teacher forcing, a left-padded row against the same row
         run alone with its unpadded prompt, and the timestamp run against
         the timestamp rules. Last, `self-attn-replay`: the read-only
         self-attention has no caller in the model (nor in the JAX
         package), so four greedy decodes at batch 32 (bf16 and int8 caches,
         without and with a prompt window) call it after every cache update
         of every layer, on the cache that update wrote, and hold its output
         bit for bit against the update kernel's.
Phase 3  first-step logits of 2 utterances, card (bf16, kernels) against
         the same port run on the CPU in f32 (plain versions): whisper-small
         int8 weights with bf16 caches and with the int8 self-KV and
         cross-KV, and int4, NF4 double-quant and HQQ int4 weights with the
         int8 caches; `pytorch_dynamic_int8`, calibrated
         `static_int8_act_int8` and `static_fp8_act_fp8`; int8 weights at
         batch 1; the f32 and the f16 tree in their own types (bounds of
         their own: an f32 tree differs by sum order only); and the
         beam5-prompt configuration (prompted, five beams). The CPU side
         of phases 3-5 (these references, forward-small's, the alignment's)
         is queued (`later`) and runs on a thread beside phase 6's held
         passes, never beside a timed pass; the tie proofs of phases 4 and
         5 run at once, in f32 on the card through the plain versions
         (`card_ties`, TF32 off, no kernel launches), as phases 7, 8 and 10
         prove theirs.
Phase 4  with no other tree resident, whisper-small with int8 weights
         through the slice-11 entry points:
           eval-headline  `evaluate_model` at the headline decode, batch 96,
                        `synthetic_dataset(192)`, one warmup batch,
                        `WordTokenizer`, a `MemoryTracker`: exact launch
                        counts, every batch's texts equal to the direct
                        call's, RTFx, batch latency, torch's peak memory
                        beside `analytic_hbm_mb`, WER on seeded weights;
           forward-small  `make_calibration_fn` (batch 2, 8 teacher-forced
                        tokens) drives `forward`; `forward`, `decode_logits`
                        and `nll_loss` in bf16 against CPU f32;
           unfused-int8   `cross_pallas=False, self_pallas=False` with int8
                        caches, batch 32: no decode attention kernel, the
                        matmul kernel as often as fused, tokens equal to the
                        fused run's under the tie rule (`check_ties`);
           merge-at6, pool2-ckv8, tome300-bf16  batch 32: `encode(merge_at=6)`,
                        `cross_kv_pool=2` over int8 cross-KV, `cross_kv_merge=
                        300` over bf16 cross-KV; the new shapes timed
                        (T = 750; S = 750; S = 1200, the kernels line's `@`
                        entries), row 0 against the f32 path on the card
                        through the plain versions under the tie rule;
           fallback     `decode_with_fallback`, batch 32, bf16 caches, the
                        default ladder, best_of 2, a seeded generator on the
                        card, the logprob gate at the median of a greedy
                        decode: the t = 0 rung bit-equal to `greedy_decode`,
                        one seed one result, each row at the rung its gates
                        give, rows kept at t = 0 and later;
         in all but eval-headline every call of a kernel is held against its
         plain version as the model makes it (`checked_kernel_calls`; each
         held block ends with a check that every launch of the kernels it
         shims was made inside a shim: the wrappers' counters against the
         launches the shims saw).
Phase 5  again with no other tree resident, whisper-small with int8 weights,
         int8 self-KV and cross-KV, through the slice-12 entry points:
           seek-small   `transcribe_seek_batch(batch_size=32,
                        stage_int16=True)` over bench.py's longform streams
                        (32 of 45-75 s, seed 3) with the timestamp band's
                        embeddings crafted (`craft_ts_embeddings`, bench.py's
                        `_craft_ts_embeddings` in torch), 25 tokens: a cold
                        and a steady call timed (rtfx: audio s / wall,
                        window_rtfx, windows, segments, mean advance), then
                        one held: each window batch cut on the card equal to
                        the host's slice of the int16 pool, idle rows zero,
                        each window's tokens equal to a direct call's, the
                        timestamp rules, segments inside their windows,
                        window counts that differ between streams;
           seek-words   `transcribe_seek` over one 60-90 s stream with
                        `word_timestamps` and `hallucination_silence_threshold`,
                        and `transcribe_seek_batch(word_timestamps=True)` over
                        4 streams: the alignment pass within ALIGN_REL_L2 of
                        CPU f32, word times in order inside their windows,
                        the words joined to the windows' text;
           spec-tiny, spec-self  `make_speculative_transcribe_fn` (batch 32,
                        gamma 4, 25 tokens, EOT suppressed) with a seeded
                        whisper-tiny draft and with `self_speculative_draft(
                        keep_decoder=2)`: tokens and lengths equal to the
                        target's greedy or parted at a proven tie
                        (`check_ties`); rounds, drafts accepted a round, the
                        wall beside greedy's;
           verified-greedy-draft, verified-junk, verified-active
                        `verified_greedy_decode` at batch 32 with a 16-token
                        prompt window and the timestamp rules: greedy's own
                        tokens, junk drafts, 8 padding lanes; tokens equal to
                        greedy's or parted at a proven tie, the padding lanes
                        fully accepted;
           longform-batched  `transcribe_long` at batch 8 over 240 s: chunk
                        texts equal to the direct call's;
         every kernel call held against its plain version (seek-small's two
         timed calls apart, which must equal its held call), exact launch
         counts, each run's seconds printed; then the shapes only phase 5
         gives the kernels (the tiny draft's, the verify windows', the
         alignment's) timed beside their plain versions and bounds, as the
         kernels line's `name@shape` entries (P5_ENTRIES).
Phase 7, timed part  the presets of `sweep/presets.py` at full width and
         depth, seeded (bf16 but for the f32 and f16 presets), int8 trees
         with fused decoder qkv, 25 tokens, EOT suppressed, three batches
         timed (rtfx as bench.py --presets counts it: batch x 7.42 s of
         audio over the mean of the two steady walls), exact launch counts
         from the tree's layers:
           largev3_s50_int8_ckv4  whisper-large-v3 (128 mels) after
                        `largev3_structured50_int8`'s transform (10 of 20
                        heads in every attention, FFN 5120 -> 2560, int8),
                        int8 self-KV, int4 cross-KV, batch 48;
           turbo_int8   whisper-large-v3-turbo (32 encoder, 4 decoder
                        layers), int8, int8 self-KV and cross-KV, batch 64;
           tiny_fp32_greedy  the f32 tree, batch 16;
           small_fp16_beam5_longform  the f16 tree, beam 5, through the
                        package's `transcribe` over 8 seeded 30 s clips
                        joined into 240 s, batch_size 8 (its rtfx: 240 s
                        over the wall);
         bench.py's small_int8 and medium_int4_kv8 rows are phase 2's
         int8-kv and medium-int4 runs. Each row prints rtfx, ms_per_batch,
         params_mb (`size_in_mb`), the seconds to build and transform the
         tree and `model_gflops`. The trees stay resident through phase 6.
Phase 6  again with whisper-small, int8 weights, cut to its first
         P6_LAYERS = 2 encoder and decoder layers (full width: the serving
         runs' host loops and held checks grow with the depth, and the
         run's time limit holds them to this; phase 7's trees resident
         beside it; no memory is measured here), int8 self-KV and cross-KV,
         through the slice-13 serving workloads;
         each run timed and run with every kernel call held against its
         plain version (the log-mel too: no further than the plain version +
         MEL_EXACT_MARGIN from the float64 log-mel), the two runs' outputs
         equal, launch counts exact in both (the CPU f32 tie proofs of
         cb-small, then the queued proofs of phases 3-5, run on a thread
         beside the held runs, never beside a timed one):
           cb-small     `ContinuousBatcher` at bench.py's continuous_batching
                        row: batch 96, 384 requests of ragged noise (1-30 s,
                        seed 1) staged as an int16 pool by `stage()`, caps
                        lognormal(log 32, 0.55) in 2..64, chunk 8, 24 admit
                        lanes, prefill disaggregation, EOT allowed; wave,
                        continuous and overlap schedulers (rtfx, occupancy,
                        device steps, chunks, stage passes, the host-phase
                        split), their tokens equal or parted at a proven tie
                        (`check_ties`), the first 48 against one greedy
                        batch at 64 tokens cut at each cap, fixed_equiv_rtfx
                        (the fixed-token decoder at the set's mean length),
                        a float32 pool under transfer="int16" refused;
           stream-steady, stream-churn  `StreamingPool` at bench.py's
                        streaming rows: 16 sessions of 32 s (bench.py: 32
                        sessions of 60 s; cut so that the passes fit the
                        run's time, each window still sliding once; noise x
                        0.1, seed 0) in 0.5 s chunks,
                        a tick a round, agreement 2,
                        min_step 1 s, timestamps on; churn: 16 s streams
                        (bench.py: 30 s; cut to fit the run's time), a
                        quarter of the sessions closed and reopened every
                        quarter of the run (aggregate_rtfx, device_rtfx, tick
                        p50/p95, occupancy, draft_accept_rate,
                        sessions_closed); churn's held pass replays the first
                        12 of its 32 rounds (one churn), its partials and
                        the churned sessions' finals equal to the timed
                        pass's; in the held pass every synced
                        mirror row bit-equal to its host window and zero past
                        it, committed text never retracting, and two steady
                        streams run alone on the pool's step: every decode
                        equal to the pool's, or the first that parts a
                        proven tie (CPU f32 with the streaming frontend);
           serve-flac, serve-openloop, serve-mulaw  `TranscriptionService`
                        at batch 32 (buckets 8, 16, 32), max_wait 5 ms,
                        pipeline 2, bench.py's serve rows: 128 FLAC requests
                        of 7.42 s (encoded by spawned processes while the
                        earlier runs go), the int16 wire, closed loop, then a
                        corrupt stream, a good one and a 65 s request;
                        96 paced at 60% of the measured e2e_rtfx; 32 on the
                        mu-law wire beside the float32 wire (e2e_rtfx,
                        busy_rtfx, occupancy, latency p50/p95, buckets, the
                        share of equal tokens); every batch equal to a
                        direct call on its rows, every request's tokens its
                        row's, the corrupt stream failing alone, the long
                        request in three chunks equal to their windows';
         then the shapes only phase 6 gives the kernels (the int8 update at
         a second-pass position with a slot's `start` there, the grouped
         kernel over admitted cross-KV, the 60-slot verify window, the
         serving bucket 8 and 32) timed as the kernels line's `name@shape`
         entries (P6_ENTRIES).
Phase 7, held part  run inside phase 6, after its held stream passes and
         before the queued CPU proofs are joined (beside them; nothing of it
         is timed): each preset run again with every kernel call held
         (`checked_kernel_calls(mel=True)`), outputs equal to the timed
         run's, launch counts exact; largev3 and turbo's first 4 rows
         recomputed in f32 on the card through the plain versions (TF32
         off; `plain_kernels`), tokens equal or parted at a tie proven in
         that recompute; tiny's and the f16 preset's CPU f32 references
         queued (`later`: tiny's first 4 rows, tie rule; the f16 preset's
         first-step logits of 2 chunks); tiny's `transcribe(timestamps=True)`
         over a seeded 60 s stream (the f32-DFT log-mel at batch 1, held to
         the float64 bound); the f16 preset's chunk texts equal to a direct
         `make_transcribe_fn` call's; `model_agreement` at 8 clips for
         largev3_structured50_int8 and medium_int4_kv8 against their
         uncompressed bf16 trees of the same seed (seeded weights: the
         numbers show the harness at scale, not accuracy); then the shapes
         only phase 7 gives the kernels timed (P7_ENTRIES).

Phase 8  (slice 15, after phase 7's timed part, before phase 6) the
         training side at whisper-small's full width and depth, seeded
         bf16 weights, each quantized tree (decoder qkv fused) decoded as
         one held batch (`p8_decode`: int8 caches, 25 tokens, EOT
         suppressed, `checked_kernel_calls(mel=True)`, exact
         launch counts, no activation record made, the first 4 rows
         against an f32 recompute on the card under the tie rule):
           gptq-small   `make_calibration_fn` over 4 seeded 30 s clips, then
                        `quantize_data_aware("gptq_int4")` on the card, over
                        the first 3 encoder and decoder layers (full width):
                        Hessian and solve seconds, the median GPTQ / RTN
                        objective under each Hessian (<= 1);
           awq-nf4-small  AWQ's statistics and alpha search on the card,
                        NF4 weights;
           smooth-w8a8-small  `smoothquant_w8a8`, batch 96, w8a8 at every
                        linear;
           prune-w8a8-small  `activation_guided_ffn_prune(0.3)` (FFN 922)
                        then `smoothquant_w8a8`: the ragged w8a8 kernel at
                        decode M and encoder M;
           mixed-small  Fisher scores of the f32 tree into
                        `generate_quant_config(6.0)`, int4 and int8 leaves
                        in one tree;
           qat-small    `qat_distill(int4, steps=3, batch=2, seq_len=8,
                        compute_dtype=f32)`: per-step loss and seconds,
                        peak memory;
         each run's seconds printed. The card-vs-CPU f32 proofs run at 2
         layers of full width, queued (`later`): encoder layer 0's fc2
         GPTQ solve, the first 2 layers' AWQ alphas, their Fisher scores,
         and QAT's step-0 loss and gradient on the same batch and teacher
         logits. Then the ragged w8a8 shapes timed (P8_ENTRIES).

Phase 9  (slice 16, after phase 8, before phase 6) storage, checkpoint
         conversion and the compression sweeps at whisper-small's full
         width and depth, seeded; batch 32, 25 tokens, EOT suppressed, int8
         caches unless said otherwise; every block's launch counts exact,
         read from what it ran (`recorded_paths`: each card log-mel, encoder
         pass, greedy decode with its steps, teacher-forced pass):
           storage-small  phase 2's int8 tree through `save_npz` and
                        `save_gzip`, an NF4 tree through gzip, an f32 tree
                        pruned 80% by `prune_global_l1` through
                        `save_sparse_zip`, each cut to its first 2 encoder
                        and decoder layers (full width; the whole depth
                        only multiplies the bytes) (how many leaves the sparse branch
                        carried); each read back onto the card, every leaf
                        bit-equal and contiguous, one held batch whose
                        tokens equal the in-memory tree's from this run;
                        write s, read s, file MB, and which sparse codec
                        served (native or numpy);
           hf-small     the seeded bf16 tree as an HF-named two-shard
                        safetensors snapshot (`write_safetensors`, the
                        config.json and generation_config.json written here),
                        `load_model(hf=dir, dtype=bf16)`: ARCHS["small"]'s
                        dimensions, every leaf bit-equal, one held batch
                        with bf16 caches, the in-memory tree's tokens;
           sweep-small  `run_sweep` over baseline_bf16, quanto_int8,
                        quanto_int4 and l1_global_50pct on
                        `synthetic_dataset(32)` with `default_tokenizer`
                        through `evaluate_model`, every kernel call held,
                        interrupted when its third config starts, then
                        resumed: configs 1-2 skipped;
           curve        `run_curve` over the int8, heads50+int8 and
                        declayers-25%+int8 rungs on the seeded tree cut to
                        its first 4 encoder and decoder layers (full width),
                        recover_steps 0: a timed
                        pass (iters 3), then a held pass (iters 1) whose
                        points equal it but for rtfx; each point's rtfx,
                        size_mb, hbm_mb and token_agreement printed;
         each part's seconds printed, then the shapes only phase 9 gives
         the kernels timed (P9_ENTRIES).

Phase 10 (slice 17; run inside phase 6, after phase 11, beside the queued
         CPU proofs: nothing of it timed on the host) the CLI at
         whisper-small's full width and depth and the parallel paths at its
         first P10_LAYERS = 2 encoder and decoder layers (full width),
         seeded, every kernel call held against its
         plain version (`checked_kernel_calls`) and the launches counted:
           cli-*        `cli.main([...])` in process, on the card by default:
                        `transcribe` of a 60 s WAV writing every format
                        (bf16 tree, batch 2), `evaluate --quant quanto_int8
                        --kv-int8` over `synthetic_dataset(32)`, `compress
                        --quant quanto_int8 --format gzip --verify`, `export
                        --load` of it to safetensors, `transcribe --weights`
                        of the export, `agreement --quant quanto_int8` over
                        8 clips, `analyze`; each result equal to the package
                        API's on the same inputs;
           dp-nccl-world1  `make_dp_transcribe` on a world of one under NCCL,
                        batch 96, int8 caches: tokens equal
                        `make_transcribe_fn`'s, launch counts exact;
           tp2, tp2-b3, dp2  a two-process group on the one card (gloo:
                        NCCL refuses two ranks on one device):
                        `make_tp_decoder` at tp = 2 (int8, qkv unfused,
                        int8 cross-KV, fp self-KV) at batch 32 (the grouped
                        cross-attention over 6 local heads) and 3 (the
                        one-query kernel), then `make_dp_transcribe` at dp =
                        2 over the headline batch of 96; tokens equal the
                        tp = 1 twin's (the same code on a world of one) and
                        `make_transcribe_fn`'s, or part at a top-2 tie proven
                        in an f32 recompute on the card (`check_ties` under
                        `plain_kernels`); rank 0 then times the shard-local
                        shapes (P10_ENTRIES).

Phase 11 (slice 18; run inside phase 6, after phase 7's held part,
         beside the queued CPU proofs: all of it held, its shapes timed by
         CUDA events) the five examples of `examples_torch/` on the
         card at their defaults (the head-dim-16 test models, f32 trees),
         each `main(["--device", "cuda"])` inside `checked_kernel_calls(mel=
         True)`: compress_store_serve, qat_recovery, serving_and_speculative,
         streaming_live, timestamps_and_profiling; then `make_transcribe_fn`
         on test2l's bf16 tree over fp, int8 and int4-cross caches at batch
         4 (16 rows: the grouped kernel) and 3 (12: the one-query kernel),
         held; every decode kernel of head dim 16 launched; the shapes
         timed as the kernels line's `name@test2l-...` entries
         (P11_BASES). Then the head dims no whole body has: the
         same runs on test2l-dh36 (d_model 144, 4 heads of 36: capacity
         64's RAGGED bodies) in f32 and bf16 trees (P11_DH36_RUNS), and
         small-h8, whisper-small's width cut into 8 heads of 96 (capacity
         128's RAGGED bodies): int8 weights, int8 self- and cross-KV, batch
         32, greedy 25 tokens, EOT suppressed, held with exact launch
         counts at full depth and at a 2-layer cut, the cut's first rows
         against CPU f32 under the tie rule; their ragged bodies timed as
         `name@test2l-dh36-...` and `name@small-h8-...` entries. Then the
         head dims past 256, the WIDE bodies: test2l-dh288
         (d_model 576, 2 heads of 288) as test2l-dh36, and small-h2
         (whisper-small's width in 2 heads of 384) as small-h8, its cut
         also behind `run_self_attention_replay` (the read-only WIDE body);
         timed as `name@test2l-dh288-...` and `name@small-h2-...` entries.
         Phase 1 holds every attention kernel at head dims 257, 384, 512 and
         1024 (`WIDE_DIMS`, 384 timed: the `*_wide_dh` entries) and the
         encoder attention in bf16, f16 and f32 at every head dim it holds,
         f32 and f16 also at whisper-small batch 96 beside `sdpa` in the same
         type (`enc_attn_f32`, `enc_attn_f16`). Since slice 21 phase 1 also
         holds, untimed, each wrapper past the grid's 65535 rows
         (`phase1_limits`: B*H, B or H = 70000, M = 65535 * 128 + 1).

Any failure exits nonzero. On success the last stdout line is
{"ok": true, "device": {...}}; the line before it lists every kernel with
its launch count, error, times and bound (and, as `name@shape`, the shapes
only token merging and phases 5, 6, 7, 8, 9, 10 and 11 give a kernel); the preset rows
are logged as one `phase7 presets {...}` line after phase 6. Needs torch
with CUDA, numpy and nvcc; never imports jax.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

SEED = 0
ARCH = "small"
BATCH = 32        # slice 1's phase-1 shapes, its bf16-KV run, the small 4-bit runs
HEAD_BATCH = 96   # bench.py's headline batch (int8 self-KV and cross-KV)
MEDIUM_BATCH = 64  # bench.py --presets' medium_int4_kv8 batch
AUDIO_S = 30.0
CSRC = "openai_whisper_compression_tpu_torch/csrc/"
JAX_PKG = "openai_whisper_compression_tpu/"
# every kernel: (entry name, wrapper module, wrapper, launch counter
# attribute, source file, the TPU kernel it replaces, phase-1 result key)
KERNELS = [
    ("log_mel_cuda", "audio.mel_kernel", "log_mel_cuda", "launches",
     "mel.cu", "audio/mel_pallas.py:62", "mel"),
    ("int8_matmul", "ops.quant_matmul", "int8_matmul", "launches",
     "quant_matmul.cu", "ops/quant_matmul.py:55", "int8_matmul"),
    ("decode_cross_attention_grouped", "ops.cross_attention",
     "decode_cross_attention_grouped", "launches", "cross_attention.cuh",
     "ops/cross_attention.py:321", "cross"),
    ("decode_self_attention_update", "ops.self_attention_step",
     "decode_self_attention_update", "launches", "self_attention_step.cu",
     "ops/self_attention_step.py:245", "self"),
    ("transpose_quant_kv", "ops.cross_attention", "transpose_quant_kv",
     "launches", "transpose_quant.cu", "ops/cross_attention.py:248", "tq"),
    ("decode_cross_attention_grouped_int8", "ops.cross_attention",
     "decode_cross_attention_grouped", "launches_int8", "cross_attention.cuh",
     "ops/cross_attention.py:306", "cross_int8"),
    ("decode_cross_attention_grouped_int4", "ops.cross_attention",
     "decode_cross_attention_grouped", "launches_int4", "cross_attention.cuh",
     "ops/cross_attention.py:313", "cross_int4"),
    ("decode_self_attention_update_int8", "ops.self_attention_step",
     "decode_self_attention_update_int8", "launches", "self_attention_step.cu",
     "ops/self_attention_step.py:386", "self_int8"),
    ("int4_matmul", "ops.quant_matmul", "int4_matmul", "launches",
     "quant_matmul.cu", "ops/quant_matmul.py:92", "int4"),
    ("nf4_matmul", "ops.quant_matmul", "nf4_matmul", "launches",
     "quant_matmul.cu", "ops/quant_matmul.py:212", "nf4"),
    ("group_asym_matmul", "ops.quant_matmul", "group_asym_matmul", "launches",
     "quant_matmul.cu", "ops/quant_matmul.py:260", "hqq"),
    ("group_asym_matmul_u8", "ops.quant_matmul", "group_asym_matmul",
     "launches_u8", "quant_matmul.cu", "ops/quant_matmul.py:260", "hqq_u8"),
    ("encoder_attention", "ops.attention", "encoder_attention", "launches",
     "encoder_attention.cu", "ops/attention.py:57", "enc_attn"),
    ("decode_self_attention_update_start", "ops.self_attention_step",
     "decode_self_attention_update", "launches_start",
     "self_attention_step.cu", "ops/self_attention_step.py:104", "self_start"),
    ("decode_self_attention_update_int8_start", "ops.self_attention_step",
     "decode_self_attention_update_int8", "launches_start",
     "self_attention_step.cu", "ops/self_attention_step.py:164",
     "self_int8_start"),
    ("decode_cross_attention_grouped_wide", "ops.cross_attention",
     "decode_cross_attention_grouped", "launches_wide", "cross_attention.cuh",
     "ops/cross_attention.py:321", "cross_wide"),
    ("decode_cross_attention_grouped_int8_wide", "ops.cross_attention",
     "decode_cross_attention_grouped", "launches_int8_wide",
     "cross_attention.cuh", "ops/cross_attention.py:306", "cross_int8_wide"),
    ("decode_cross_attention_grouped_int4_wide", "ops.cross_attention",
     "decode_cross_attention_grouped", "launches_int4_wide",
     "cross_attention.cuh", "ops/cross_attention.py:313", "cross_int4_wide"),
    ("w8a8_matmul", "ops.quant_matmul", "w8a8_matmul", "launches",
     "w8a8_matmul.cu", "ops/quant_matmul.py:341", "w8a8"),
    ("w8a8_matmul_static", "ops.quant_matmul", "w8a8_matmul", "launches_static",
     "w8a8_matmul.cu", "ops/quant_matmul.py:330", "w8a8_static"),
    ("decode_cross_attention", "ops.cross_attention", "decode_cross_attention",
     "launches", "cross_attention.cuh", "ops/cross_attention.py:151", "cross1"),
    ("decode_cross_attention_int8", "ops.cross_attention",
     "decode_cross_attention", "launches_int8", "cross_attention.cuh",
     "ops/cross_attention.py:99", "cross1_int8"),
    ("decode_cross_attention_int4", "ops.cross_attention",
     "decode_cross_attention", "launches_int4", "cross_attention.cuh",
     "ops/cross_attention.py:133", "cross1_int4"),
    ("decode_self_attention", "ops.self_attention_step", "decode_self_attention",
     "launches", "self_attention_step.cu", "ops/self_attention_step.py:320",
     "attend"),
    ("decode_self_attention_start", "ops.self_attention_step",
     "decode_self_attention", "launches_start", "self_attention_step.cu",
     "ops/self_attention_step.py:96", "attend_start"),
    ("decode_self_attention_int8", "ops.self_attention_step",
     "decode_self_attention", "launches_int8", "self_attention_step.cu",
     "ops/self_attention_step.py:314", "attend_int8"),
    ("decode_self_attention_int8_start", "ops.self_attention_step",
     "decode_self_attention", "launches_int8_start", "self_attention_step.cu",
     "ops/self_attention_step.py:309", "attend_int8_start"),
    # the f32 and f16 bodies of the decode attention kernels
    ("decode_self_attention_update_f32", "ops.self_attention_step",
     "decode_self_attention_update", "launches_f32", "self_attention_step.cu",
     "ops/self_attention_step.py:245", "self_f32"),
    ("decode_self_attention_update_f16", "ops.self_attention_step",
     "decode_self_attention_update", "launches_f16", "self_attention_step.cu",
     "ops/self_attention_step.py:245", "self_f16"),
    ("decode_self_attention_update_f16_start", "ops.self_attention_step",
     "decode_self_attention_update", "launches_f16_start",
     "self_attention_step.cu", "ops/self_attention_step.py:104", "self_f16_start"),
    # f32 q and cache with `start`: the streaming prompt window and the
    # timestamped long-form's at head dim 16 (phase 11)
    ("decode_self_attention_update_f32_start", "ops.self_attention_step",
     "decode_self_attention_update", "launches_f32_start",
     "self_attention_step.cu", "ops/self_attention_step.py:104", "self_f32_start"),
    ("decode_cross_attention_grouped_f32", "ops.cross_attention",
     "decode_cross_attention_grouped", "launches_f32", "cross_attention.cuh",
     "ops/cross_attention.py:321", "cross_f32"),
    ("decode_cross_attention_grouped_f16", "ops.cross_attention",
     "decode_cross_attention_grouped", "launches_f16", "cross_attention.cuh",
     "ops/cross_attention.py:321", "cross_f16"),
    ("decode_cross_attention_grouped_f16_wide", "ops.cross_attention",
     "decode_cross_attention_grouped", "launches_f16_wide", "cross_attention.cuh",
     "ops/cross_attention.py:321", "cross_f16_wide"),
    # f32 q over 5-8 slots: the streaming pool's prompt window at head dim 16
    # (phase 11)
    ("decode_cross_attention_grouped_f32_wide", "ops.cross_attention",
     "decode_cross_attention_grouped", "launches_f32_wide", "cross_attention.cuh",
     "ops/cross_attention.py:321", "cross_f32_wide"),
    ("decode_cross_attention_f32", "ops.cross_attention", "decode_cross_attention",
     "launches_f32", "cross_attention.cuh", "ops/cross_attention.py:151",
     "cross1_f32"),
    ("decode_cross_attention_f16", "ops.cross_attention", "decode_cross_attention",
     "launches_f16", "cross_attention.cuh", "ops/cross_attention.py:151",
     "cross1_f16"),
    # the encoder attention's f32 (3xTF32 on wgmma at head dim 64) and f16
    # tensor-core bodies, at whisper-small batch 96
    ("encoder_attention_f32", "ops.attention", "encoder_attention", "launches_f32",
     "encoder_attention_f32_wg.cu", "ops/attention.py:57", "enc_attn_f32"),
    ("encoder_attention_f16", "ops.attention", "encoder_attention", "launches_f16",
     "encoder_attention_f16.cu", "ops/attention.py:57", "enc_attn_f16"),
    # the WIDE bodies (head dims past 256), each timed at head dim 384
    # (whisper-small's width in 2 heads: phase 11's small-h2)
    ("encoder_attention_wide_dh", "ops.attention", "encoder_attention", "launches_wide_dh",
     "encoder_attention_wide.cu", "ops/attention.py:57", "dh384 encoder_attention"),
    # the f32 WIDE body (3xTF32), launched on small-h2's 2-layer f32 encode
    ("encoder_attention_f32_wide_dh", "ops.attention", "encoder_attention",
     "launches_f32_wide_dh", "encoder_attention_f32_wide.cu", "ops/attention.py:57",
     "dh384 encoder_attention torch.float32"),
    ("transpose_quant_kv_wide_dh", "ops.cross_attention", "transpose_quant_kv",
     "launches_wide_dh", "transpose_quant.cu", "ops/cross_attention.py:248",
     "dh384 transpose_quant_kv torch.bfloat16"),
    ("decode_cross_attention_grouped_wide_dh", "ops.cross_attention",
     "decode_cross_attention_grouped", "launches_wide_dh", "cross_attention_wide.cu",
     "ops/cross_attention.py:321", "dh384 grouped int8 K=1"),
    ("decode_cross_attention_wide_dh", "ops.cross_attention", "decode_cross_attention",
     "launches_wide_dh", "cross_attention_wide.cu", "ops/cross_attention.py:151",
     "dh384 one_query bf16"),
    ("decode_self_attention_update_wide_dh", "ops.self_attention_step",
     "decode_self_attention_update", "launches_wide_dh", "self_attention_step_wide.cu",
     "ops/self_attention_step.py:245", "dh384 self_update torch.bfloat16"),
    ("decode_self_attention_update_int8_wide_dh", "ops.self_attention_step",
     "decode_self_attention_update_int8", "launches_wide_dh", "self_attention_step_wide.cu",
     "ops/self_attention_step.py:386", "dh384 self_update_int8"),
    ("decode_self_attention_wide_dh", "ops.self_attention_step", "decode_self_attention",
     "launches_wide_dh", "self_attention_step_wide.cu", "ops/self_attention_step.py:320",
     "dh384 self_attention_int8"),
]
# the encoder attention's entries, one a body family: each counts one launch
# an encoder layer where the run's path holds it
ENCODER_ENTRIES = ("encoder_attention", "encoder_attention_f32", "encoder_attention_f16",
                   "encoder_attention_wide_dh", "encoder_attention_f32_wide_dh")
KV8 = {"kv_int8": True, "cross_kv_int8": True}
DECODE_KERNELS = ("log_mel_cuda", "encoder_attention", "transpose_quant_kv",
                  "decode_cross_attention_grouped_int8",
                  "decode_self_attention_update_int8")
# phase-2 runs: (name, arch, weight quantization, DecodeConfig switches,
# batch, batches with EOT suppressed, EOT-allowed batch after them, kernels
# of the path); the entry of KERNELS reports the launch count of the first
# run whose path holds it
SMALL_KERNELS = ("log_mel_cuda", "encoder_attention", "int8_matmul")
RUNS = [
    ("bf16-kv", ARCH, "int8", {}, BATCH, 3, True,
     ("log_mel_cuda", "encoder_attention", "int8_matmul",
      "decode_cross_attention_grouped", "decode_self_attention_update")),
    ("int8-kv", ARCH, "int8", KV8, HEAD_BATCH, 3, True,
     ("int8_matmul",) + DECODE_KERNELS),
    ("int4-ckv", ARCH, "int8", {"kv_int8": True, "cross_kv_int4": True},
     HEAD_BATCH, 1, False,
     ("log_mel_cuda", "encoder_attention", "int8_matmul",
      "decode_cross_attention_grouped_int4",
      "decode_self_attention_update_int8")),
    ("medium-int4", "medium", "int4", KV8, MEDIUM_BATCH, 3, False,
     ("int4_matmul",) + DECODE_KERNELS),
    ("small-nf4dq", ARCH, "bnb_nf4_double_quant", KV8, BATCH, 1, False,
     ("nf4_matmul",) + DECODE_KERNELS),
    ("small-hqq4", ARCH, "hqq_int4", KV8, BATCH, 1, False,
     ("group_asym_matmul",) + DECODE_KERNELS),
    ("small-hqq8", ARCH, "hqq_int8", KV8, BATCH, 1, False,
     ("group_asym_matmul_u8",) + DECODE_KERNELS),
    ("small-w8a8-dyn", ARCH, "pytorch_dynamic_int8", KV8, HEAD_BATCH, 3, False,
     ("w8a8_matmul",) + DECODE_KERNELS),
    ("small-w8a8-static", ARCH, "static_int8_act_int8", KV8, BATCH, 1, False,
     ("w8a8_matmul_static",) + DECODE_KERNELS),
    ("small-w4a8-static", ARCH, "static_int4_act_int8", KV8, BATCH, 1, False,
     ("w8a8_matmul_static",) + DECODE_KERNELS),
    ("small-fp8", ARCH, "static_fp8_act_fp8", KV8, BATCH, 1, False, DECODE_KERNELS),
    ("small-b1", ARCH, "int8", KV8, 1, 3, True,
     SMALL_KERNELS + ("transpose_quant_kv", "decode_cross_attention_grouped_int8",
                      "decode_cross_attention_int8",
                      "decode_self_attention_update_int8")),
    ("small-b3-bf16", ARCH, "int8", {}, 3, 1, False,
     SMALL_KERNELS + ("decode_cross_attention_grouped", "decode_cross_attention",
                      "decode_self_attention_update")),
    ("small-b3-int4ckv", ARCH, "int8", {"kv_int8": True, "cross_kv_int4": True},
     3, 1, False,
     SMALL_KERNELS + ("decode_cross_attention_grouped_int4",
                      "decode_cross_attention_int4",
                      "decode_self_attention_update_int8")),
    # f32 and f16 trees (no quantized weights: no matmul kernel; the encoder
    # attention's f32 and f16 bodies): caches in the tree's own type
    ("small-f32", ARCH, "baseline_fp32", {}, 16, 1, False,
     ("log_mel_cuda", "encoder_attention_f32", "decode_cross_attention_grouped_f32",
      "decode_self_attention_update_f32")),
    ("small-b3-f32", ARCH, "baseline_fp32", {}, 3, 1, False,
     ("log_mel_cuda", "encoder_attention_f32", "decode_cross_attention_grouped_f32",
      "decode_cross_attention_f32", "decode_self_attention_update_f32")),
    ("small-b3-f16", ARCH, "fp16", {}, 3, 1, False,
     ("log_mel_cuda", "encoder_attention_f16", "decode_cross_attention_grouped_f16",
      "decode_cross_attention_f16", "decode_self_attention_update_f16")),
]
# prompt-conditioned phase-2 runs of whisper-small: (name, DecodeConfig
# switches, batch[, weights: int8 unless given]); two batches each, EOT
# suppressed, a PROMPT_W-token prompt window with lengths mixed over
# 4..PROMPT_W
PROMPT_W = 16
NEW_TOKENS = 25
BEAM5 = {"beam_size": 5, "kv_int8": True, "cross_kv_int8": True}
PROMPT_RUNS = [
    ("beam5-prompt", BEAM5, 16),
    ("greedy-prompt-ts", {"notimestamps": False}, 32),
    ("beam5-int4ckv", {"beam_size": 5, "kv_int8": True, "cross_kv_int4": True}, 16),
    ("small-f16-beam5", {"beam_size": 5}, 8, "fp16"),
]
# the runs `--profile` profiles: the fp cache update's run, the headline,
# the w8a8 path, beam search, batch 1
PROFILED = ("bf16-kv", "int8-kv", "small-w8a8-dyn", "beam5-prompt", "small-b1")
# phase-3 configurations: (name, weight quantization, DecodeConfig switches)
LOGIT_RUNS = [("int8 bf16-kv", "int8", {}), ("int8 int8-kv", "int8", KV8),
              ("int4 int8-kv", "int4", KV8),
              ("nf4-dq int8-kv", "bnb_nf4_double_quant", KV8),
              ("hqq-int4 int8-kv", "hqq_int4", KV8),
              ("w8a8-dyn int8-kv", "pytorch_dynamic_int8", KV8),
              ("w8a8-static int8-kv", "static_int8_act_int8", KV8),
              ("fp8-fp8 int8-kv", "static_fp8_act_fp8", KV8),
              ("f32 f32-kv", "baseline_fp32", {}), ("f16 f16-kv", "fp16", {})]
# phase-1 4-bit weight kinds: (label, quantize_params method, wrapper key,
# the RUNS entry whose decoder linears give the shapes; the kinds on no
# run's path take the run of their kernel)
FOUR_BIT = [("int4", "int4", "int4", "medium-int4"),
            ("nf4", "nf4", "nf4", "small-nf4dq"),
            ("fp4-dq", "fp4_dq", "nf4", "small-nf4dq"),
            ("hqq4", "hqq_int4", "hqq", "small-hqq4"),
            ("hqq3", "hqq_int3", "hqq", "small-hqq4"),
            ("hqq8", "hqq_int8", "hqq_u8", "small-hqq8")]

# Tolerances, card kernel vs plain version on identical inputs (the plain
# versions compute in f32 from the same bf16-rounded operands):
# - mel: the kernel no less exact than its plain version. Both are held
#   against the float64 log-mel on the same operands
#   (`features.log_mel_f64`): the kernel's largest distance from it at most
#   the plain version's + 5e-6. Two f32 chains that sum in different orders
#   each stray up to ~3e-5 from the exact value on rare ill-conditioned bins
#   (an H100 80GB HBM3 at 700 W read 1.24e-5 and 1.30e-5 at batch 96, both
#   3.08e-5 under the f32 DFT), so they cannot be held to 1e-5 of each
#   other; a power spectrum or mel product kept in bf16 would stray 1e-4 or
#   more further.
MEL_EXACT_MARGIN = 5e-6
# - bf16 outputs (int8 matmul, attention): the two sides round f32 values
#   that differ only by sum order, so they differ by at most one bf16 step
#   (2**-8 to 2**-7 of the value): 2**-7 of the reference's own largest
#   magnitude.
BF16_REL = 2.0 ** -7
# - f16 outputs likewise by one f16 step (2**-11 to 2**-10 of the value), f32
#   outputs by sum order and the exponential's last bits: 2**-10 and 1e-5 of
#   the reference's largest magnitude.
KERNEL_REL = {torch.bfloat16: BF16_REL, torch.float16: 2.0 ** -10,
              torch.float32: 1e-5}
# - slice, card bf16 vs CPU f32 first-step logits: bf16 activations (2**-9
#   relative rounding per op) through 24 residual blocks, int8 weights equal
#   on both sides; a few percent expected, while a layout or indexing fault
#   gives an error of order 1.
LOGITS_REL_L2 = 0.1
# - the same with quantized activations. Every linear's input differs on the
#   two sides by its bf16 rounding (2**-9 relative), which moves a share of
#   the activation codes across a rounding boundary: an int8 code by one step
#   (1/127 of the row's or tensor's maximum), an fp8 code by one step of its
#   three mantissa bits (2**-4 to 2**-3 of the value). Those errors are not
#   shared by the two sides and add up over 150 linears. Runs on an H100
#   80GB HBM3 at 700 W read 0.027 (dynamic int8), 0.031 (static int8) and
#   0.065 (fp8), the same in every run since the weights are seeded. The
#   bounds leave a factor of about 1.5 for another torch version's kernels:
#   0.05 for int8 activations, 0.1 for fp8. A fault that only doubles the
#   error (a wrong `act_scale`, a clip placed after the cast) then fails.
ACT_LOGITS_REL_L2 = {"pytorch_dynamic_int8": 0.05, "static_int8_act_int8": 0.05,
                     "static_fp8_act_fp8": 0.1}
# - an f32 tree on the card (full f32 products, TF32 off) against the same
#   tree on the CPU differs by sum order only; an f16 tree (f16 activations,
#   2**-11 relative rounding per op, f32 sums) by less than a bf16 one. A run
#   on an H100 80GB HBM3 at 700 W read 8.732e-07 and 0.001288; the bounds
#   are twice the readings, rounded up to two digits.
TREE_LOGITS_REL_L2 = {"baseline_fp32": 1.8e-6, "fp16": 0.0026}
# - a left-padded prompt row against the same row run alone with its
#   unpadded prompt, both on the card in bf16: the same function, computed at
#   another batch size and window length (other launch shapes, so bf16
#   roundings fall elsewhere through 12 layers): a few 1e-3 expected.
PROMPT_ROW_REL_L2 = 0.03
# - a beam's summed logprob (25 tokens, of order -200) against the same
#   tokens rescored by teacher forcing at another batch shape, bf16 logits:
#   0.5% of the score (runs read 0.01-0.05%); a cache row gathered from the
#   wrong beam is off by far more.
RESCORE_REL = 0.005

# Published dense peaks of one H100 SXM (NVIDIA's data sheet), for the
# bounds: device memory bytes/s, tensor-core bf16 FLOP/s and int8 OP/s, f32
# FLOP/s outside the tensor cores, TF32 FLOP/s on them.
HBM_BPS, BF16_FLOPS, F32_FLOPS, INT8_OPS = 3.35e12, 989e12, 67e12, 1979e12
TF32_FLOPS = 495e12


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def bound(moved_bytes: float, op_seconds: float) -> dict:
    """The least time the card could take: the bytes the function must move
    (each input read once, each output written once) over the memory rate,
    or its operations over the peak rate of their type (`op_seconds`),
    whichever is larger."""
    byte_seconds = moved_bytes / HBM_BPS
    return {"bound_ms": 1e3 * max(byte_seconds, op_seconds),
            "bound_by": "bytes" if byte_seconds >= op_seconds else "operations"}


def peak_flops(dtype: torch.dtype) -> float:
    """The card's peak rate for products of `dtype`: the tensor cores' for
    bf16 and f16, the f32 rate outside them for f32."""
    return F32_FLOPS if dtype == torch.float32 else BF16_FLOPS


def enc_attn_op_seconds(flop: float, dtype: torch.dtype) -> float:
    """The least time the encoder attention's products take on the card:
    bf16 and f16 at the tensor cores' peak; f32-accurate products as three
    TF32 products each (3xTF32) at the TF32 peak, whatever body runs."""
    return 3 * flop / TF32_FLOPS if dtype == torch.float32 else flop / BF16_FLOPS


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale=None,
         attn_mask=None):
    """PyTorch's fused attention, timed beside the attention kernels as a
    yardstick only: nothing in the port calls it."""
    return F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask, scale=scale)


def check(cond, msg) -> None:
    """Fail the run (explicitly, so that `python -O` cannot drop it)."""
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Mean device time per call over `iters` back-to-back calls. A spin
    kernel (~25 ms) runs first, so the host has enqueued every call before
    the timed region starts: the events then time the device, not the
    Python wrapper's launch rate (which bounds a 10 µs kernel)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# Bytes over which `cuda_ms_cold` rotates its copies of a call's buffers:
# more than the H100's 50 MB L2, so that each call finds its inputs in
# device memory, as a decode step finds its caches.
COLD_BYTES = 64e6


def cuda_ms_cold(fn, tensors: list, iters: int = 20) -> float:
    """Mean device time per call of fn(*copy), rotating over as many copies
    of `tensors` (every tensor argument of the call, made anew here) as
    exceed COLD_BYTES together, each copy used at least once, after a spin
    kernel as in `cuda_ms`."""
    n = int(COLD_BYTES // max(1, nbytes(*tensors))) + 2
    copies = [[t.clone() if isinstance(t, torch.Tensor) else t for t in tensors]
              for _ in range(n)]
    iters = max(iters, n)
    for c in copies:
        fn(*c)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for i in range(iters):
        fn(*copies[i % n])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def held_only(phase: str, what: str, shape, err: float, tol: float) -> dict:
    """Log a call held against its plain version and not timed (phase 1's
    ragged head dims); its result entry holds the error alone."""
    log(f"{phase} {what} {shape}: held, err {err:.3g} (bound {tol:.3g})".lstrip())
    return {"max_abs_err": err}


def check_grouped(what: str, qg: torch.Tensor, kv: tuple, s_valid: int,
                  phase: str = "phase1", timed: bool = True) -> dict:
    """The grouped cross-attention kernel on q (BH, K, 64) and kv = (k_t,
    v_t, k_scale, v_scale) against its plain version, with times, its bound
    (the valid part of K/V and its scales read once) and, for K/V in q's own
    type, PyTorch's fused attention on the same tensors (not `timed`: held
    only)."""
    from openai_whisper_compression_tpu_torch.ops.cross_attention import (
        decode_cross_attention_grouped, decode_cross_attention_grouped_ref)

    bh, kq, dh = qg.shape
    got = decode_cross_attention_grouped(qg, *kv, s_valid)
    ref = decode_cross_attention_grouped_ref(qg, *kv, s_valid)
    err, tol = max_err(got, ref), KERNEL_REL[qg.dtype] * float(ref.float().abs().max())
    check(got.dtype == qg.dtype and err <= tol, f"{what}: err {err} > {tol}")
    if not timed:
        return held_only(phase, what, tuple(kv[0].shape), err, tol)
    t_k = cuda_ms(lambda: decode_cross_attention_grouped(qg, *kv, s_valid))
    t_p = cuda_ms(lambda: decode_cross_attention_grouped_ref(qg, *kv, s_valid))
    k_t, v_t, k_scale, _ = kv
    valid = s_valid / k_t.shape[2]
    least = bound(nbytes(qg, got) + valid * nbytes(*kv),
                  4 * bh * kq * dh * s_valid / peak_flops(k_t.dtype))
    t_lib = None
    if k_scale is None:
        k, v = (t[:, :, :s_valid].transpose(1, 2) for t in (k_t, v_t))
        t_lib = cuda_ms(lambda: sdpa(qg, k, v, scale=1.0))
    log(f"{phase} {what} {tuple(k_t.shape)} s_valid {s_valid}: err {err:.3g} "
        f"(bound {tol:.3g}) kernel {t_k:.4f} ms plain {t_p:.4f} ms least "
        f"{least['bound_ms']:.4f} ms ({least['bound_by']})"
        + ("" if t_lib is None else f" sdpa {t_lib:.4f} ms"))
    return {"max_abs_err": err, "ms": t_k, "plain_ms": t_p, **least,
            "library_ms": t_lib}


def check_update(what: str, bh: int, pos: int, gen, int8: bool,
                 start: torch.Tensor | None, dtype=torch.bfloat16, dh: int = 64,
                 s: int = 64, phase: str = "phase1", timed: bool = True) -> dict:
    """One of the two cache-update kernels over an `s`-row cache of `bh` rows
    of head dim `dh` against its plain version, q, the fresh rows and an fp
    cache in `dtype`: caches (codes and scales) bit for bit, the output
    within one step of `dtype`, one launch counted; with warm and cold times
    (`cold_ms`) and its bound (the rows start..pos read once, row pos
    written)."""
    from openai_whisper_compression_tpu_torch.ops import self_attention_step as sas

    dev = gen.device
    qf = (torch.randn(bh, dh, generator=gen, device=dev) * dh ** -0.5).to(dtype)
    kn, vn = (torch.randn(2, bh, dh, generator=gen, device=dev) * 2).to(dtype)
    if int8:
        fn, ref_fn = (sas.decode_self_attention_update_int8,
                      sas.decode_self_attention_update_int8_ref)
        kc, vc = torch.randint(-127, 128, (2, bh, s, dh), generator=gen,
                               device=dev, dtype=torch.int8)
        ks, vs = torch.rand(2, bh, s, generator=gen, device=dev) * 0.03 + 1e-3
        bufs = [kc, vc, ks, vs]
        attr = "launches"
    else:
        fn, ref_fn = (sas.decode_self_attention_update,
                      sas.decode_self_attention_update_ref)
        bufs = [torch.randn(bh, s, dh, generator=gen, device=dev).to(dtype)
                for _ in range(2)]
        attr = "launches" + _SUFFIX[dtype]
    attr += "" if start is None else "_start"
    refs = [t.clone() for t in bufs]
    before = getattr(fn, attr)
    got = fn(qf, kn, vn, *bufs, pos, start=start)
    check(getattr(fn, attr) == before + 1, f"{what}: {attr} did not count one launch")
    ref = ref_fn(qf, kn, vn, *refs, pos, start=start)
    err, tol = max_err(got, ref), KERNEL_REL[dtype] * float(ref.float().abs().max())
    check(all(torch.equal(a, r) for a, r in zip(bufs, refs)),
          f"{what} pos={pos}: cache rows or scales differ")
    check(err <= tol, f"{what} pos={pos}: err {err} > {tol}")
    if not timed:
        return held_only(phase, f"{what} pos={pos}", (bh, s, dh), err, tol)
    t_k = cuda_ms(lambda: fn(qf, kn, vn, *bufs, pos, start=start))
    t_p = cuda_ms(lambda: ref_fn(qf, kn, vn, *refs, pos, start=start))
    # the decode step finds its cache in device memory
    t_c = cuda_ms_cold(lambda *a: fn(*a, pos, start=start), [qf, kn, vn, *bufs])
    rows = bh * (pos + 1) - (0 if start is None else int(start.sum()))
    per_row = sum(t[0, 0].numel() * t.element_size() for t in bufs)
    least = bound(nbytes(qf, kn, vn, got) + per_row * (rows + bh),
                  4 * dh * rows / peak_flops(torch.bfloat16 if int8 else dtype))
    log(f"{phase} {what} pos={pos} ({bh}, {s}, {dh})"
        + ("" if start is None else f" start {int(start.min())}..{int(start.max())}")
        + f": err {err:.3g} (bound {tol:.3g}) caches equal; kernel {t_k:.4f} ms "
        f"(cold {t_c:.4f} ms) plain {t_p:.4f} ms least {least['bound_ms']:.5f} ms "
        f"({least['bound_by']})")
    return {"max_abs_err": err, "ms": t_k, "cold_ms": t_c, "plain_ms": t_p, **least,
            "library_ms": None}


def mel_exactness(what: str, wav: torch.Tensor, got: torch.Tensor,
                  ref: torch.Tensor, n_mels: int, dtype: torch.dtype) -> tuple:
    """The largest distances of the kernel's log-mel `got` and the plain
    version's `ref` from the float64 log-mel of the same operands; fails
    unless the kernel is within MEL_EXACT_MARGIN of the plain version's."""
    from openai_whisper_compression_tpu_torch.audio import features

    exact = features.log_mel_f64(wav, n_mels, dtype)
    err_k, err_p = (float((x.double() - exact).abs().max()) for x in (got, ref))
    log(f"mel {what}: from the float64 log-mel, kernel {err_k:.3g}, plain {err_p:.3g} "
        f"(the kernel may be {MEL_EXACT_MARGIN:g} further)")
    check(err_k <= err_p + MEL_EXACT_MARGIN,
          f"mel {what}: the kernel is {err_k} from the float64 log-mel, the plain "
          f"version {err_p}")
    return err_k, err_p


def check_mel(dev, gen, b: int, dtype: torch.dtype, n_mels: int = 80) -> dict:
    """`log_mel_cuda` on b seeded 30 s clips (n_mels mels) against the plain pipeline: the
    kernel no less exact than it against the float64 result; the whole call and
    the kernel alone timed beside the plain version, and two bounds: over
    the filterbank's nonzeros (what the function needs; the one the kernels
    line carries) and with the dense 201 x 80 filterbank."""
    from openai_whisper_compression_tpu_torch.audio import features, mel_kernel

    wav = torch.randn(b, 480_000, generator=gen, device=dev) * 0.1
    got = mel_kernel.log_mel_cuda(wav, n_mels, dtype)
    ref = features.log_mel(wav, n_mels, dtype)
    err = max_err(got, ref)
    what = (f"({b}, 480000) {'bf16' if dtype == torch.bfloat16 else 'f32'} DFT"
            + ("" if n_mels == 80 else f", {n_mels} mels"))
    check(got.shape == (b, n_mels, 3000), f"mel {what}: shape {tuple(got.shape)}")
    mel_exactness(what, wav, got, ref, n_mels, dtype)
    ops = mel_kernel.mel_operands(wav, n_mels, dtype)
    frames = b * ops.n_frames   # re and im: 400 taps x 201 bins, in the DFT dtype
    dft = frames * 4 * 400 * 201 / peak_flops(dtype)
    nonzeros = int(ops.bands[:, 1].sum())
    res = {"max_abs_err": err,
           "ms": cuda_ms(lambda: mel_kernel.log_mel_cuda(wav, n_mels, dtype)),
           "plain_ms": cuda_ms(lambda: features.log_mel(wav, n_mels, dtype)),
           **bound(nbytes(wav, got), dft + frames * 2 * nonzeros / F32_FLOPS),
           "library_ms": None}
    kernel_ms = cuda_ms(lambda: mel_kernel.launch(ops, dtype))
    dense = bound(nbytes(wav, got), dft + frames * 2 * 201 * n_mels / F32_FLOPS)
    log(f"phase1 mel {what}: from the plain version {err:.3g}; whole call "
        f"{res['ms']:.4f} ms, kernel alone {kernel_ms:.4f} ms, plain "
        f"{res['plain_ms']:.4f} ms; least {res['bound_ms']:.4f} ms "
        f"({res['bound_by']}) over the filterbank's {nonzeros} nonzeros, "
        f"{dense['bound_ms']:.4f} ms ({dense['bound_by']}) with it dense")
    return res


def phase1(dev, results: dict) -> None:
    from openai_whisper_compression_tpu_torch.ops.qtensor import dequantize
    from openai_whisper_compression_tpu_torch.ops.quant_matmul import (
        int8_matmul, int8_matmul_ref)
    from openai_whisper_compression_tpu_torch.quant.core import quantize_int8

    gen = torch.Generator(device=dev).manual_seed(SEED)
    bf16 = torch.bfloat16

    # mel: 32 x 30 s and the headline's 96 x 30 s with the bf16 DFT
    # (fast_mel), 32 x 30 s with the f32 DFT
    for b, dtype in ((BATCH, bf16), (HEAD_BATCH, bf16), (BATCH, torch.float32)):
        res = check_mel(dev, gen, b, dtype)
        if (b, dtype) == (BATCH, bf16):
            results["mel"] = res

    # int8 matmul at every decoder linear shape, M = a batch-32 step, and a
    # step and the prefill of the headline batch (96, 3 x 96)
    errs, rows = [], []
    for k, n, what in ((768, 2304, "qkv"), (768, 768, "o/cross q/cross o"),
                       (768, 3072, "fc1"), (3072, 768, "fc2")):
        q = quantize_int8(torch.randn(k, n, generator=gen, device=dev) * 0.02)
        for m in (BATCH, HEAD_BATCH, 3 * HEAD_BATCH):
            x = torch.randn(m, k, generator=gen, device=dev).to(bf16)
            got = int8_matmul(x, q.data, q.scale)
            ref = int8_matmul_ref(x, q.data, q.scale)
            err, tol = max_err(got, ref), BF16_REL * float(ref.float().abs().max())
            check(err <= tol, f"int8_matmul M={m} K={k} N={n}: err {err} > {tol}")
            errs.append(err)
            t_k = cuda_ms(lambda: int8_matmul(x, q.data, q.scale))
            t_p = cuda_ms(lambda: int8_matmul_ref(x, q.data, q.scale))
            t_d = cuda_ms(lambda: torch.matmul(x, dequantize(q, bf16)))
            least = bound(nbytes(x, q.data, q.scale, got), 2 * m * k * n / BF16_FLOPS)
            rows.append((m, k, n, what, err, t_k, t_p, t_d, least))
            log(f"phase1 int8_matmul M={m} K={k} N={n} ({what}): err {err:.3g} "
                f"(bound {tol:.3g}) "
                f"kernel {t_k:.4f} ms plain {t_p:.4f} ms "
                f"dequant+torch.matmul {t_d:.4f} ms least {least['bound_ms']:.5f} ms "
                f"({least['bound_by']})")
    qkv96 = rows[1]   # the qkv projection of a decode step of the headline batch
    check(qkv96[:4] == (HEAD_BATCH, 768, 2304, "qkv"), "not the headline's qkv")
    results["int8_matmul"] = {"max_abs_err": max(errs), "ms": qkv96[5],
                              "plain_ms": qkv96[6], **qkv96[8],
                              "library_ms": qkv96[7]}

    # grouped cross-attention: K = 1 (a greedy step), 3 (the prefix's
    # prefill), 5 (a beam-5 step) and 8 (a full launch of a prompt window)
    bh, s_pad, s_valid = BATCH * 12, 1536, 1500
    k_t = torch.randn(bh, 64, s_pad, generator=gen, device=dev).to(bf16)
    v_t = torch.randn(bh, 64, s_pad, generator=gen, device=dev).to(bf16)
    errs = []
    for kq in (1, 3, 5, 8):
        qg = (torch.randn(bh, kq, 64, generator=gen, device=dev) * 0.125).to(bf16)
        res = check_grouped(f"cross_attention_grouped K={kq}", qg,
                            (k_t, v_t, None, None), s_valid)
        if kq == 1:
            results["cross"] = res
        elif kq == 8:   # the greedy-prompt-ts prefill's full launches
            results["cross_wide"] = res
        else:
            errs.append(res["max_abs_err"])
    results["cross"]["max_abs_err"] = max(errs + [results["cross"]["max_abs_err"]])
    del k_t, v_t
    # the same widths at the headline batch's 1152 rows, and 5 slots at the
    # beam runs' 192, as the int8 and int4 bodies are timed
    bh = HEAD_BATCH * 12
    k_t, v_t = (torch.randn(bh, 64, s_pad, generator=gen, device=dev).to(bf16)
                for _ in range(2))
    for kq, rows in ((1, bh), (3, bh), (5, bh), (8, bh), (5, 16 * 12)):
        qg = (torch.randn(rows, kq, 64, generator=gen, device=dev) * 0.125).to(bf16)
        check_grouped(f"cross_attention_grouped K={kq}", qg,
                      (k_t[:rows], v_t[:rows], None, None), s_valid)
    del k_t, v_t

    # self-attention update over a 64-row bf16 cache at bf16-kv's 384 rows,
    # and with the mixed `start` of the greedy-prompt-ts run (16 - prompt
    # length: 0..12); at 36 rows (batch 3)
    bh = BATCH * 12
    errs = []
    for pos in (3, 30, 63):
        res = check_update("self_attention_update", bh, pos, gen, False, None)
        if pos == 30:
            results["self"] = res
        errs.append(res["max_abs_err"])
    results["self"]["max_abs_err"] = max(errs)
    start = (torch.arange(bh, device=dev) // 12 * 5 % 13).to(torch.int32)
    results["self_start"] = check_update("self_attention_update start", bh, 30,
                                         gen, False, start)
    check_update("self_attention_update", 36, 30, gen, False, None)


def check_tq(x: torch.Tensor, h: int, phase: str = "phase1", timed: bool = True) -> tuple:
    """`transpose_quant_kv` on x (B, S, H * 64) bit for bit against its plain
    version, timed beside it and its bound; returns the result entry, the
    codes and the scales."""
    from openai_whisper_compression_tpu_torch.ops.cross_attention import (
        transpose_quant_kv, transpose_quant_kv_ref)

    q, sc = transpose_quant_kv(x, h)
    q_ref, sc_ref = transpose_quant_kv_ref(x, h)
    what = f"{tuple(x.shape)} {str(x.dtype).removeprefix('torch.')} -> {tuple(q.shape)} int8"
    check(torch.equal(q, q_ref) and torch.equal(sc, sc_ref),
          f"transpose_quant_kv {what}: codes or scales differ from the plain version")
    if not timed:
        return held_only(phase, "transpose_quant_kv", what, 0.0, 0.0), q, sc
    res = {"max_abs_err": max(max_err(q, q_ref), max_err(sc, sc_ref)),
           "ms": cuda_ms(lambda: transpose_quant_kv(x, h)),
           "plain_ms": cuda_ms(lambda: transpose_quant_kv_ref(x, h)),
           # an abs, a max, a divide and a rounding per element, f32
           **bound(nbytes(x, q, sc), 4 * x.numel() / F32_FLOPS),
           "library_ms": None}
    log(f"{phase} transpose_quant_kv {what}: codes and scales equal; kernel "
        f"{res['ms']:.4f} ms plain {res['plain_ms']:.4f} ms least "
        f"{res['bound_ms']:.4f} ms ({res['bound_by']})")
    return res, q, sc


def phase1_quantized(dev, results: dict) -> None:
    """The int8/int4-KV kernels at the shapes of bench.py's batch 96."""
    from openai_whisper_compression_tpu_torch.models.whisper import _quant_kv4_t
    from openai_whisper_compression_tpu_torch.ops.cross_attention import (
        transpose_kv, transpose_quant_kv)

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    bf16 = torch.bfloat16
    b, s, h = HEAD_BATCH, 1500, 12
    bh = b * h

    # transpose + int8 quantize of a cross K and a cross V projection, and of
    # whisper-medium's at its preset's batch 64 (the medium-int4 run)
    xk, xv = ((torch.randn(b, s, h * 64, generator=gen, device=dev) * 0.4).to(bf16)
              for _ in range(2))
    results["tq"], k8, ks8 = check_tq(xk, h)
    v8, vs8 = transpose_quant_kv(xv, h)
    check_tq((torch.randn(MEDIUM_BATCH, s, 1024, generator=gen, device=dev) * 0.4)
             .to(bf16), 16)
    k4, ks4 = _quant_kv4_t(transpose_kv(xk, h))
    v4, vs4 = _quant_kv4_t(transpose_kv(xv, h))
    t_q4 = cuda_ms(lambda: _quant_kv4_t(transpose_kv(xk, h)))
    log(f"phase1 int4 cross-KV transpose + quantize + pack ({b}, {s}, "
        f"{h * 64}) bf16, plain torch (no kernel, as in the JAX package): "
        f"{t_q4:.4f} ms")
    del xk, xv

    # int8 and int4 grouped cross-attention: K = 1 (a greedy step), 3 (the
    # prefix's prefill), 5 and 8 at batch 96; then K = 5 at the beam runs'
    # batch 16 (B*H = 192), the shape their decode steps give the kernel
    beam_bh = 16 * h
    for key, what, kv in (("cross_int8", "int8", (k8, v8, ks8, vs8)),
                          ("cross_int4", "int4", (k4, v4, ks4, vs4))):
        errs = []
        for kq in (1, 3, 5, 8):
            qg = (torch.randn(bh, kq, 64, generator=gen, device=dev) * 0.125).to(bf16)
            res = check_grouped(f"cross_attention_grouped {what} K={kq}", qg, kv, s)
            if kq == 1:
                results[key] = res
            errs.append(res["max_abs_err"])
        results[key]["max_abs_err"] = max(errs)
        qg = (torch.randn(beam_bh, 5, 64, generator=gen, device=dev) * 0.125).to(bf16)
        results[key + "_wide"] = check_grouped(
            f"cross_attention_grouped {what} K=5", qg,
            tuple(t[:beam_bh] for t in kv), s)
    del k8, v8, k4, v4

    # int8 self-attention update over a 64-row int8 cache, and with the mixed
    # `start` of the beam5-prompt run at its 16 x 5 rows (B*H = 960)
    errs = []
    for pos in (3, 30, 63):
        res = check_update("self_attention_update_int8", bh, pos, gen, True, None)
        if pos == 30:
            results["self_int8"] = res
        errs.append(res["max_abs_err"])
    results["self_int8"]["max_abs_err"] = max(errs)
    rows = 16 * 5 * h
    start = (torch.arange(rows, device=dev) // (5 * h) * 5 % 13).to(torch.int32)
    results["self_int8_start"] = check_update("self_attention_update_int8 start",
                                              rows, 30, gen, True, start)


def phase1_attention(dev, results: dict) -> None:
    """The encoder attention at whisper-small batch 96 (B*H = 1152) and
    whisper-medium batch 64 (B*H = 1024), T = 1500, on (B, H, T, 64) views
    of (B, T, H*64) projections (the strided layout the model hands it),
    against its plain version on all rows (its f32 scores, 10.4 and 9.2 GB,
    fit beside the inputs), beside PyTorch's fused attention."""
    from openai_whisper_compression_tpu_torch.models.whisper import split_heads
    from openai_whisper_compression_tpu_torch.ops.attention import (
        encoder_attention, encoder_attention_ref)

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    t = 1500
    # the card's second operations bound: one exponential per score on the
    # special-function units, 16 a clock on each SM, at the card's top clock
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, b, h in (("small", HEAD_BATCH, 12), ("medium", MEDIUM_BATCH, 16)):
        q, k, v = (split_heads(torch.randn(b, t, h * 64, generator=gen, device=dev)
                               .to(torch.bfloat16), h) for _ in range(3))
        got = encoder_attention(q, k, v)
        torch.cuda.synchronize()
        ref = encoder_attention_ref(q, k, v)
        err, tol = max_err(got, ref), BF16_REL * float(ref.float().abs().max())
        check(got.shape == (b, h, t, 64) and bool(torch.isfinite(got).all()),
              f"encoder_attention {name}: output not finite or of shape "
              f"{tuple(got.shape)}")
        check(err <= tol, f"encoder_attention {name}: err {err} > {tol}")
        del ref
        t_k = cuda_ms(lambda: encoder_attention(q, k, v))
        t_p = cuda_ms(lambda: encoder_attention_ref(q, k, v), warmup=1, iters=3)
        t_lib = cuda_ms(lambda: sdpa(q, k, v))
        flop = 4 * b * h * t * t * 64
        least = bound(4 * b * h * t * 64 * 2, flop / BF16_FLOPS)
        ex2_ms = 1e3 * b * h * t * t / (sm_count * 16 * sm_mhz * 1e6)
        res = {"max_abs_err": err, "ms": t_k, "plain_ms": t_p, **least,
               "library_ms": t_lib}
        if name == "small":
            results["enc_attn"] = res
        log(f"phase1 encoder_attention {name} ({b}, {h}, {t}, 64) bf16: err "
            f"{err:.3g} (bound {tol:.3g}) kernel {t_k:.4f} ms "
            f"({flop / t_k / 1e9:.1f} TFLOP/s) plain {t_p:.4f} ms sdpa "
            f"{t_lib:.4f} ms least {least['bound_ms']:.4f} ms ({least['bound_by']}); "
            f"its exponentials alone {ex2_ms:.4f} ms ({sm_count} SMs x 16 a clock "
            f"at {sm_mhz:.0f} MHz)")
        del q, k, v, got
        torch.cuda.empty_cache()
    # the f32 (3xTF32) and f16 tensor-core bodies at whisper-small batch 96,
    # beside `sdpa` in the same type (TF32 off); the f32 bound is three TF32
    # products a product at 495 TFLOP/s (3 x 6.6e11 flop: 4.0 ms)
    for dtype, key in ((torch.float32, "enc_attn_f32"), (torch.float16, "enc_attn_f16")):
        q, k, v = (split_heads(torch.randn(HEAD_BATCH, 1500, 12 * 64, generator=gen,
                                           device=dev).to(dtype), 12) for _ in range(3))
        results[key] = check_enc_attn_shape(f"phase1 encoder_attention small {dtype}",
                                            q, k, v)
        del q, k, v
        torch.cuda.empty_cache()
    # times only, at a length of whole 128-key tiles: what the ragged T = 1500
    # costs the kernel and the library call
    b, h, t = HEAD_BATCH, 12, 1536
    q, k, v = (split_heads(torch.randn(b, t, h * 64, generator=gen, device=dev)
                           .to(torch.bfloat16), h) for _ in range(3))
    t_k, t_lib = cuda_ms(lambda: encoder_attention(q, k, v)), cuda_ms(lambda: sdpa(q, k, v))
    flop = 4 * b * h * t * t * 64
    log(f"phase1 encoder_attention small ({b}, {h}, {t}, 64) bf16, whole tiles: kernel "
        f"{t_k:.4f} ms ({flop / t_k / 1e9:.1f} TFLOP/s) sdpa {t_lib:.4f} ms")
    del q, k, v
    torch.cuda.empty_cache()


def int_mm_library(x, w, scale, act_scale=None):
    """The same function through PyTorch's int8 product (cuBLASLt), timed
    beside the w8a8 kernel as a yardstick only: nothing in the port calls
    it."""
    from openai_whisper_compression_tpu_torch.ops.quant_matmul import (
        quantize_act_int8)

    xq, sx = quantize_act_int8(x, act_scale)
    return (torch._int_mm(xq, w).float() * sx * scale).to(x.dtype)


def phase1_w8a8(dev, results: dict) -> None:
    """The w8a8 matmul, dynamic and static, at whisper-small's four linears
    at M = 96 (a decode step of the small-w8a8-dyn run) and M = 96 x 1500
    (its encoder), bf16 activations, on the call `linear` makes
    (`kernel_call`): bit-equal to its plain version, with times beside the
    plain version, quantize + `torch._int_mm` + epilogue, and
    `torch.matmul(x, dequantize(q, bf16))`, the call the weight-only path
    makes at that M. Under torch.profiler: a decode-M call is one kernel,
    and how an encoder-scale call's time splits between its quantize pass
    and its GEMM."""
    from openai_whisper_compression_tpu_torch.config import ARCHS
    from openai_whisper_compression_tpu_torch.ops.linear import kernel_call
    from openai_whisper_compression_tpu_torch.ops.qtensor import dequantize
    from openai_whisper_compression_tpu_torch.ops.quant_matmul import (
        w8a8_matmul, w8a8_matmul_ref)
    from openai_whisper_compression_tpu_torch.quant.core import quantize_int8
    from torch.profiler import ProfilerActivity, profile as tprofile

    def kernels_of(call) -> dict:
        """Device kernel name -> (calls, device ms) of one run of `call`."""
        call()
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        return {e.key: (e.count, e.self_device_time_total / 1e3)
                for e in device_kernels(prof.key_averages())}

    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    for k, n, what in linear_shapes(ARCHS[ARCH]):
        q = quantize_int8(torch.randn(k, n, generator=gen, device=dev) * 0.02)
        for m in (HEAD_BATCH, HEAD_BATCH * 1500):
            x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
            x[m // 2] = 0.0   # an all-zero row: the scale's 1e-12 floor
            # a frozen scale as a calibration would leave it: absmax / 127
            frozen = (x.abs().max().float() / 127.0).reshape(())
            few = {"warmup": 1, "iters": 3} if m > 1024 else {}
            t_d = cuda_ms(lambda: torch.matmul(x, dequantize(q, torch.bfloat16)), **few)
            for key, qa in (("w8a8", dataclasses.replace(q, act="dynamic_int8")),
                            ("w8a8_static", dataclasses.replace(
                                q, act="static_int8", act_scale=frozen))):
                fn, plain_fn, args = kernel_call(qa)
                check(fn is w8a8_matmul and plain_fn is w8a8_matmul_ref,
                      f"{key}: linear does not launch w8a8_matmul")
                got = fn(x, *args)
                torch.cuda.synchronize()
                ref = plain_fn(x, *args)
                check(got.shape == (m, n) and got.dtype == x.dtype
                      and bool(torch.isfinite(got).all()),
                      f"{key} M={m} K={k} N={n}: output not finite or of shape "
                      f"{tuple(got.shape)}")
                check(torch.equal(got, ref),
                      f"{key} M={m} K={k} N={n}: differs from the plain version "
                      f"(max {max_err(got, ref)})")
                lib = int_mm_library(x, *args)
                lib_err = max_err(lib, ref)
                del ref, lib
                t_k = cuda_ms(lambda: fn(x, *args), **few)
                t_p = cuda_ms(lambda: plain_fn(x, *args), **few)
                t_l = cuda_ms(lambda: int_mm_library(x, *args), **few)
                least = bound(nbytes(x, got, *args), 2 * m * k * n / INT8_OPS)
                if (m, what) == (HEAD_BATCH, "qkv"):
                    results[key] = {"max_abs_err": 0.0, "ms": t_k, "plain_ms": t_p,
                                    **least, "library_ms": t_l}
                    ks = kernels_of(lambda: fn(x, *args))
                    check(sum(c for c, _ in ks.values()) == 1,
                          f"{key} M={m}: a decode-step call enqueued {ks}, not one kernel")
                    log(f"phase1 {key} M={m} ({what}): one kernel a call, "
                        f"{list(ks)[0][:60]}")
                log(f"phase1 {key} M={m} K={k} N={n} ({what}): equal to the plain "
                    f"version bit for bit; kernel {t_k:.4f} ms "
                    f"({2 * m * k * n / t_k / 1e9:.1f} TOP/s) plain {t_p:.4f} ms "
                    f"quantize+torch._int_mm+epilogue {t_l:.4f} ms (off by "
                    f"{lib_err:.3g}) dequant+torch.matmul {t_d:.4f} ms least "
                    f"{least['bound_ms']:.5f} ms ({least['bound_by']})")
                if m > 1024 and (key, what) == ("w8a8", "fc1"):
                    ks = kernels_of(lambda: fn(x, *args))
                    quant = sum(t for name, (_, t) in ks.items() if "quantize" in name)
                    total = sum(t for _, t in ks.values())
                    log(f"phase1 {key} M={m} ({what}) under torch.profiler: "
                        f"quantize pass {quant:.4f} ms of {total:.4f} ms "
                        f"({', '.join(f'{nm[:40]} {t:.4f}' for nm, (_, t) in ks.items())})")
                del got
            del x
        torch.cuda.empty_cache()


def phase1_small_batch(dev, results: dict) -> None:
    """The one-query cross-attention at 12 and 36 rows (whisper-small at
    batch 1 and 3) over bf16, int8 and int4 K/V, against its plain version
    and against the grouped kernel at one slot on the same inputs; and the
    read-only self-attention at (384, 64, 64) bf16 and (1152, 64, 64) int8,
    pos 30, without and with a mixed `start`, against its plain version and
    bit for bit against the update kernel's output."""
    from openai_whisper_compression_tpu_torch.models.whisper import _quant_kv4_t
    from openai_whisper_compression_tpu_torch.ops import self_attention_step as sas
    from openai_whisper_compression_tpu_torch.ops.cross_attention import (
        decode_cross_attention, decode_cross_attention_grouped,
        decode_cross_attention_ref, transpose_kv, transpose_quant_kv)

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    bf16 = torch.bfloat16
    s, h = 1500, 12
    for b in (1, 3):
        bh = b * h
        xk, xv = ((torch.randn(b, s, h * 64, generator=gen, device=dev) * 0.4).to(bf16)
                  for _ in range(2))
        (k8, ks8), (v8, vs8) = (transpose_quant_kv(t, h) for t in (xk, xv))
        (k4, ks4), (v4, vs4) = (_quant_kv4_t(transpose_kv(t, h)) for t in (xk, xv))
        kb, vb = (transpose_kv(t, h) for t in (xk, xv))
        qf = (torch.randn(bh, 64, generator=gen, device=dev) * 0.125).to(bf16)
        for key, what, kv in (("cross1", "bf16", (kb, vb, None, None)),
                              ("cross1_int8", "int8", (k8, v8, ks8, vs8)),
                              ("cross1_int4", "int4", (k4, v4, ks4, vs4))):
            got = decode_cross_attention(qf, *kv, s)
            ref = decode_cross_attention_ref(qf, *kv, s)
            grouped = decode_cross_attention_grouped(qf[:, None, :].contiguous(),
                                                     *kv, s)[:, 0, :]
            err, tol = max_err(got, ref), BF16_REL * float(ref.float().abs().max())
            err_g = max_err(got, grouped)
            check(got.shape == (bh, 64) and err <= tol,
                  f"cross_attention {what} BH={bh}: err {err} > {tol}")
            check(err_g <= tol, f"cross_attention {what} BH={bh}: off by {err_g} "
                                f"from the grouped kernel at one slot (> {tol})")
            t_k = cuda_ms(lambda: decode_cross_attention(qf, *kv, s))
            t_c = cuda_ms_cold(lambda *a: decode_cross_attention(*a, s), [qf, *kv])
            t_p = cuda_ms(lambda: decode_cross_attention_ref(qf, *kv, s))
            t_g = cuda_ms(lambda: decode_cross_attention_grouped(
                qf[:, None, :], *kv, s))
            least = bound(nbytes(qf, got) + s / kv[0].shape[2] * nbytes(*kv),
                          4 * bh * 64 * s / BF16_FLOPS)
            t_lib = None
            if kv[2] is None:
                k, v = (t[:, :, :s].transpose(1, 2) for t in kv[:2])
                t_lib = cuda_ms(lambda: sdpa(qf[:, None, :], k, v, scale=1.0))
            res = {"max_abs_err": err, "ms": t_k, "plain_ms": t_p, **least,
                   "library_ms": t_lib}
            if b == 1:
                results[key] = res
            else:
                results[key]["max_abs_err"] = max(err, results[key]["max_abs_err"])
            log(f"phase1 cross_attention {what} BH={bh} s_valid {s}: err {err:.3g}, "
                f"from the grouped kernel {err_g:.3g} (bound {tol:.3g}) kernel "
                f"{t_k:.4f} ms (cold {t_c:.4f} ms) grouped kernel {t_g:.4f} ms plain "
                f"{t_p:.4f} ms least "
                f"{least['bound_ms']:.5f} ms ({least['bound_by']})"
                + ("" if t_lib is None else f" sdpa {t_lib:.4f} ms"))

    pos = 30
    for int8, bh, key in ((False, BATCH * h, "attend"), (True, HEAD_BATCH * h,
                                                         "attend_int8")):
        for with_start in (False, True):
            start = ((torch.arange(bh, device=dev) // h * 5 % 13).to(torch.int32)
                     if with_start else None)
            qf = (torch.randn(bh, 64, generator=gen, device=dev) * 0.125).to(bf16)
            kn, vn = (torch.randn(2, bh, 64, generator=gen, device=dev) * 2).to(bf16)
            if int8:
                kc, vc = torch.randint(-127, 128, (2, bh, 64, 64), generator=gen,
                                       device=dev, dtype=torch.int8)
                ks, vs = torch.rand(2, bh, 64, generator=gen, device=dev) * 0.03 + 1e-3
                bufs, scales = [kc, vc, ks, vs], {"k_scale": ks, "v_scale": vs}
                upd = sas.decode_self_attention_update_int8
            else:
                bufs = [torch.randn(bh, 64, 64, generator=gen, device=dev).to(bf16)
                        for _ in range(2)]
                scales, upd = {}, sas.decode_self_attention_update
            out_upd = upd(qf, kn, vn, *bufs, pos, start=start)
            written = [t.clone() for t in bufs]

            def attend():
                return sas.decode_self_attention(qf, bufs[0], bufs[1], pos,
                                                 start=start, **scales)

            got = attend()
            ref = sas.decode_self_attention_ref(qf, bufs[0], bufs[1], pos,
                                                start=start, **scales)
            what = f"self_attention{'_int8' if int8 else ''}" + (
                " start" if with_start else "")
            err, tol = max_err(got, ref), BF16_REL * float(ref.float().abs().max())
            check(torch.equal(got, out_upd),
                  f"{what}: differs from the update kernel's output on the cache "
                  f"it wrote (max {max_err(got, out_upd)})")
            check(all(torch.equal(a, b) for a, b in zip(bufs, written)),
                  f"{what}: the read-only kernel wrote to the cache")
            check(err <= tol, f"{what}: err {err} > {tol}")
            t_k = cuda_ms(attend)
            t_c = cuda_ms_cold(lambda q_, *b: sas.decode_self_attention(
                q_, b[0], b[1], pos, start=start,
                **({"k_scale": b[2], "v_scale": b[3]} if int8 else {})),
                [qf, *bufs])
            t_p = cuda_ms(lambda: sas.decode_self_attention_ref(
                qf, bufs[0], bufs[1], pos, start=start, **scales))
            rows = bh * (pos + 1) - (0 if start is None else int(start.sum()))
            per_row = sum(t[0, 0].numel() * t.element_size() for t in bufs)
            least = bound(nbytes(qf, got) + per_row * rows, 4 * 64 * rows / BF16_FLOPS)
            t_lib = None
            if not int8:
                # one sdpa call computes the bf16 bodies; `start` is a boolean
                # mask (True = attend), built once outside the timed call
                mask = (None if start is None else
                        (torch.arange(pos + 1, device=dev) >= start[:, None])[:, None])
                lib = sdpa(qf[:, None, :], bufs[0][:, : pos + 1], bufs[1][:, : pos + 1],
                           attn_mask=mask, scale=1.0)[:, 0]
                check(max_err(lib, ref) <= tol,
                      f"{what}: sdpa is off by {max_err(lib, ref)} (> {tol}): "
                      f"not the same function")
                t_lib = cuda_ms(lambda: sdpa(qf[:, None, :], bufs[0][:, : pos + 1],
                                             bufs[1][:, : pos + 1], attn_mask=mask,
                                             scale=1.0))
            results[key + ("_start" if with_start else "")] = {
                "max_abs_err": err, "ms": t_k, "cold_ms": t_c, "plain_ms": t_p,
                **least, "library_ms": t_lib}
            log(f"phase1 {what} pos={pos} ({bh}, 64, 64): equal to the update "
                f"kernel's output bit for bit; err {err:.3g} (bound {tol:.3g}) kernel "
                f"{t_k:.4f} ms (cold {t_c:.4f} ms) plain {t_p:.4f} ms least "
                f"{least['bound_ms']:.5f} ms "
                f"({least['bound_by']})"
                + ("" if t_lib is None else f" sdpa {t_lib:.4f} ms"))


def phase1_dtypes(dev, results: dict) -> None:
    """The f32 and f16 bodies of the decode attention kernels against their
    plain versions, at the shapes of the runs that launch them: the cache
    update at 192 and 36 rows (small-f32, batch 16; batch 3) and, with the
    mixed `start` of the small-f16-beam5 run, at its 8 x 5 x 12 = 480 rows;
    the grouped cross-attention at 1 slot over 192 rows and at 5 slots over
    the beam run's 96 rows; the one-query cross-attention at 36 rows (batch
    3). Two
    bodies that no run launches are held and timed here only: the int8 cache
    update under f32 and f16 q, and the read-only self-attention over an f32
    and an f16 cache (bit for bit against the update kernel's output)."""
    from openai_whisper_compression_tpu_torch.ops import self_attention_step as sas
    from openai_whisper_compression_tpu_torch.ops.cross_attention import (
        decode_cross_attention, decode_cross_attention_ref)

    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    h, s_pad, s_valid = 12, 1536, 1500
    rows, beam_rows = 16 * h, 8 * 5 * h
    start = (torch.arange(beam_rows, device=dev) // (5 * h) * 5 % 13).to(torch.int32)
    for dtype, tag in ((torch.float32, "f32"), (torch.float16, "f16")):
        results["self_" + tag] = check_update(
            f"self_attention_update {tag}", rows, 30, gen, False, None, dtype)
        results[f"self_{tag}_start"] = check_update(
            f"self_attention_update {tag} start", beam_rows, 30, gen, False, start, dtype)
        check_update(f"self_attention_update {tag}", 3 * h, 30, gen, False, None, dtype)
        check_update(f"self_attention_update_int8 {tag} q", rows, 30, gen, True, None,
                     dtype)
        qf = (torch.randn(rows, 64, generator=gen, device=dev) * 0.125).to(dtype)
        kn, vn = (torch.randn(2, rows, 64, generator=gen, device=dev) * 2).to(dtype)
        kc, vc = (torch.randn(rows, 64, 64, generator=gen, device=dev).to(dtype)
                  for _ in range(2))
        out_upd = sas.decode_self_attention_update(qf, kn, vn, kc, vc, 30)
        check(torch.equal(sas.decode_self_attention(qf, kc, vc, 30), out_upd),
              f"self_attention {tag}: differs from the update kernel's output on "
              "the cache it wrote")
        t_k = cuda_ms(lambda: sas.decode_self_attention(qf, kc, vc, 30))
        t_c = cuda_ms_cold(lambda *a: sas.decode_self_attention(*a, 30), [qf, kc, vc])
        t_p = cuda_ms(lambda: sas.decode_self_attention_ref(qf, kc, vc, 30))
        log(f"phase1 self_attention {tag} pos=30 ({rows}, 64, 64): equal to the "
            f"update kernel's output bit for bit; kernel {t_k:.4f} ms (cold "
            f"{t_c:.4f} ms) plain {t_p:.4f} ms")
        k_t, v_t = (torch.randn(rows, 64, s_pad, generator=gen, device=dev).to(dtype)
                    for _ in range(2))
        for kq, bh in ((1, rows), (5, 8 * h)):
            qg = (torch.randn(bh, kq, 64, generator=gen, device=dev) * 0.125).to(dtype)
            res = check_grouped(f"cross_attention_grouped {tag} K={kq}", qg,
                                (k_t[:bh], v_t[:bh], None, None), s_valid)
            results["cross_" + tag + ("" if kq == 1 else "_wide")] = res
        bh = 3 * h
        qf = (torch.randn(bh, 64, generator=gen, device=dev) * 0.125).to(dtype)
        kv = (k_t[:bh], v_t[:bh], None, None)
        got = decode_cross_attention(qf, *kv, s_valid)
        ref = decode_cross_attention_ref(qf, *kv, s_valid)
        err, tol = max_err(got, ref), KERNEL_REL[dtype] * float(ref.float().abs().max())
        check(got.shape == (bh, 64) and got.dtype == dtype and err <= tol,
              f"cross_attention {tag} BH={bh}: err {err} > {tol}")
        t_k = cuda_ms(lambda: decode_cross_attention(qf, *kv, s_valid))
        t_c = cuda_ms_cold(lambda *a: decode_cross_attention(*a, s_valid), [qf, *kv])
        t_p = cuda_ms(lambda: decode_cross_attention_ref(qf, *kv, s_valid))
        k, v = (t[:, :, :s_valid].transpose(1, 2) for t in kv[:2])
        t_lib = cuda_ms(lambda: sdpa(qf[:, None, :], k, v, scale=1.0))
        least = bound(nbytes(qf, got) + s_valid / s_pad * nbytes(*kv),
                      4 * bh * 64 * s_valid / peak_flops(dtype))
        results["cross1_" + tag] = {"max_abs_err": err, "ms": t_k, "plain_ms": t_p,
                                    **least, "library_ms": t_lib}
        log(f"phase1 cross_attention {tag} BH={bh} s_valid {s_valid}: err {err:.3g} "
            f"(bound {tol:.3g}) kernel {t_k:.4f} ms (cold {t_c:.4f} ms) plain "
            f"{t_p:.4f} ms least "
            f"{least['bound_ms']:.5f} ms ({least['bound_by']}) sdpa {t_lib:.4f} ms")
        del k_t, v_t


def phase1_crossover(dev) -> None:
    """Every storage trait of the dequant-matmul beside dequant +
    torch.matmul at whisper-small's qkv (768 x 2304) and fc2 (3072 x 768),
    M = 32, 96, 288 and 1024 (the largest M `linear` still sends to the
    kernels): where the two cross. Times only; the checks are elsewhere."""
    from openai_whisper_compression_tpu_torch.ops.linear import kernel_call
    from openai_whisper_compression_tpu_torch.ops.qtensor import dequantize
    from openai_whisper_compression_tpu_torch.quant.core import QUANTIZERS

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    bf16 = torch.bfloat16
    for k, n, what in ((768, 2304, "qkv"), (3072, 768, "fc2")):
        w = torch.randn(k, n, generator=gen, device=dev) * 0.02
        for method in ("int8", "int4", "nf4", "hqq_int4", "hqq_int8"):
            q = QUANTIZERS[method](w)
            fn, _, args = kernel_call(q)
            cells = []
            for m in (32, 96, 288, 1024):
                x = torch.randn(m, k, generator=gen, device=dev).to(bf16)
                t_k = cuda_ms(lambda: fn(x, *args))
                t_d = cuda_ms(lambda: torch.matmul(x, dequantize(q, bf16)))
                cells.append(f"M={m} {t_k:.4f} vs {t_d:.4f}")
            log(f"phase1 crossover {method} {what} K={k} N={n}, kernel vs "
                f"dequant+torch.matmul ms: " + "; ".join(cells))


def linear_shapes(arch) -> tuple:
    """(K, N, what) of every decoder linear of `arch` (fused qkv)."""
    d, f = arch.d_model, arch.ffn_dim
    return ((d, 3 * d, "qkv"), (d, d, "o/cross q/cross o"), (d, f, "fc1"),
            (f, d, "fc2"))


def phase1_4bit(dev, results: dict) -> None:
    """The int4, NF4/FP4 and HQQ dequant-matmuls against their plain
    versions and beside dequant + torch.matmul, on the weights and calls
    `linear` makes (`kernel_call`): at the decoder linears of the phase-2
    run of each kind, M = batch (a decode step) and 3 x batch (the prefill
    of three prefix tokens), and at whisper-medium's linears, M = 64 and
    256, for every kind."""
    from openai_whisper_compression_tpu_torch.config import ARCHS
    from openai_whisper_compression_tpu_torch.ops.linear import kernel_call
    from openai_whisper_compression_tpu_torch.ops.qtensor import dequantize
    from openai_whisper_compression_tpu_torch.quant.core import QUANTIZERS

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    bf16 = torch.bfloat16
    runs = {r[0]: r for r in RUNS}
    counter = {key: (fn, attr) for _, _, fn, attr, _, _, key in KERNELS}
    weights, xs = {}, {}
    for label, method, key, run_name in FOUR_BIT:
        _, arch_name, _, _, batch = runs[run_name][:5]
        step = (arch_name, batch)   # the kernels line reports its qkv
        cases = dict.fromkeys([step, (arch_name, 3 * batch),
                               ("medium", MEDIUM_BATCH), ("medium", 256)])
        errs = []
        for arch_name, m in cases:
            for k, n, what in linear_shapes(ARCHS[arch_name]):
                if (k, n) not in weights:
                    weights[k, n] = torch.randn(k, n, generator=gen, device=dev) * 0.02
                if (m, k) not in xs:
                    xs[m, k] = torch.randn(m, k, generator=gen, device=dev).to(bf16)
                q, x = QUANTIZERS[method](weights[k, n]), xs[m, k]
                call = kernel_call(q)
                check(call is not None, f"{label} K={k}: no kernel on the card")
                fn, plain_fn, args = call
                kernel, plain = (lambda: fn(x, *args)), (lambda: plain_fn(x, *args))
                before = getattr(fn, counter[key][1])
                got, ref = kernel(), plain()
                check(fn.__name__ == counter[key][0]
                      and getattr(fn, counter[key][1]) == before + 1,
                      f"{label}: linear does not launch {'.'.join(counter[key])}")
                err = max_err(got, ref)
                tol = BF16_REL * float(ref.float().abs().max())
                check(got.shape == (m, n) and err <= tol,
                      f"{label} {arch_name} M={m} K={k} N={n}: err {err} > {tol}")
                errs.append(err)
                t_k, t_p = cuda_ms(kernel), cuda_ms(plain)
                t_d = cuda_ms(lambda: torch.matmul(x, dequantize(q, bf16)))
                least = bound(nbytes(x, got, *args), 2 * m * k * n / BF16_FLOPS)
                if (arch_name, m, what) == (*step, "qkv") and key not in results:
                    results[key] = {"ms": t_k, "plain_ms": t_p, **least,
                                    "library_ms": t_d}
                log(f"phase1 {label} {arch_name} M={m} K={k} N={n} ({what}): err "
                    f"{err:.3g} (bound {tol:.3g}) kernel {t_k:.4f} ms plain "
                    f"{t_p:.4f} ms dequant+torch.matmul {t_d:.4f} ms least "
                    f"{least['bound_ms']:.5f} ms ({least['bound_by']})")
        results[key]["max_abs_err"] = max(errs + [results[key].get("max_abs_err", 0.0)])


def make_params(dev, arch_name: str, method: str):
    """Seeded random bf16 weights of `arch_name`, `quantize_params(method)`
    (a QUANTIZERS method or a REGISTRY name), decoder qkv fused."""
    from openai_whisper_compression_tpu_torch.config import ARCHS
    from openai_whisper_compression_tpu_torch.models.fuse import fuse_qkv
    from openai_whisper_compression_tpu_torch.models.params import init_params
    from openai_whisper_compression_tpu_torch.quant.api import (REGISTRY,
                                                                quantize_params)

    arch = ARCHS[arch_name]
    params = init_params(arch, seed=SEED, dtype=torch.bfloat16, device=dev)
    params = fuse_qkv(quantize_params(params, method))
    if method in REGISTRY and REGISTRY[method].needs_calibration:
        params = calibrate(dev, arch, params, method)
    return arch, params


def calibrate(dev, arch, params, method: str):
    """`calibrate_static` on the card: one eager transcription of a batch of
    32 (the first batch of the configuration's run; uncalibrated tensors
    quantize per row meanwhile) records every quantized linear's input
    absmax, which is frozen into its `act_scale`."""
    from openai_whisper_compression_tpu_torch.config import DecodeConfig
    from openai_whisper_compression_tpu_torch.evaluation.harness import (
        make_transcribe_fn)
    from openai_whisper_compression_tpu_torch.models.params import named_leaves
    from openai_whisper_compression_tpu_torch.ops.qtensor import QTensor
    from openai_whisper_compression_tpu_torch.quant.api import calibrate_static

    fn = make_transcribe_fn(arch, DecodeConfig(
        max_new_tokens=NEW_TOKENS, suppress_tokens=(arch.eos_token_id,), **KV8),
        fast_mel=True, fast_gelu=True, device=dev)
    wav = torch.from_numpy(waveforms(SEED, BATCH)).to(dev)
    t0 = time.perf_counter()
    frozen = calibrate_static(params, lambda p: fn(p, wav))
    scales = [leaf.act_scale for _, leaf in named_leaves(frozen)
              if isinstance(leaf, QTensor)]
    check(len(scales) == 6 * arch.encoder_layers + 8 * arch.decoder_layers
          and all(s is not None and s.dim() == 0 and s.is_cuda and float(s) > 0
                  for s in scales),
          f"{method}: a quantized linear was left without a positive act_scale")
    log(f"phase2 calibrate {method}: {len(scales)} activation scales in "
        f"{time.perf_counter() - t0:.2f} s, min {min(map(float, scales)):.4g} max "
        f"{max(map(float, scales)):.4g}")
    return frozen


def waveforms(seed: int, batch: int) -> np.ndarray:
    """Seeded synthetic 30 s batch: noise under a few drifting tones."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(AUDIO_S * 16000), dtype=np.float32) / 16000.0
    f0 = rng.uniform(100.0, 300.0, size=(batch, 1)).astype(np.float32)
    tone = 0.3 * np.sin(2 * np.pi * f0 * t * (1 + 0.05 * np.sin(0.5 * t)))
    return (tone + 0.05 * rng.standard_normal((batch, t.size))).astype(np.float32)


def eot_twin_params(params: dict, tokens: torch.Tensor, p_len: int, eot: int):
    """Params whose EOT embedding row is 1.02 x that of one generated token,
    the twin. The output projection is tied to the embedding, so EOT then
    outscores the twin wherever the twin's logit is positive, and a row stops
    where it would have emitted the twin, or where the twin came within 2%
    of the top logit. (1.02 clears the bf16 rounding of the logits, 2**-9;
    with random weights the top logits lie so close that 1.3 stops every
    row at the first step.) `tokens` come from a
    run with EOT suppressed; the twin is the token whose first appearances
    give the rows the most distinct stopping steps. Returns the params, the
    twin and those steps (25 for a row that never emits it)."""
    gen = tokens[:, p_len: p_len + 25].numpy()

    def stops(t):
        return sorted({int(np.argmax(r == t)) + 1 if (r == t).any() else 25
                       for r in gen})

    if len(gen) == 1:   # one row: the token of its 13th step, so it stops by then
        twin = int(gen[0, 12])
    else:
        twin = max(np.unique(gen).tolist(), key=lambda t: len(stops(t)))
    embed = params["decoder"]["embed"].clone()
    embed[eot] = 1.02 * embed[twin]
    return ({**params, "decoder": {**params["decoder"], "embed": embed}},
            twin, stops(twin))


def launch_counters() -> dict:
    """Entry name -> (wrapper, counter attribute), for every kernel."""
    import importlib

    return {name: (getattr(importlib.import_module(
        "openai_whisper_compression_tpu_torch." + mod), fn), attr)
        for name, mod, fn, attr, *_ in KERNELS}


def zero_launches() -> dict:
    """Every kernel's launch count set to 0 once the card is idle; returns
    the counters for `read_launches`."""
    counters = launch_counters()
    torch.cuda.synchronize()
    for ledger in _HELD_BLOCKS:     # an open held block keeps the counts so far
        ledger.fold()
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    return counters


def read_launches(counters: dict) -> dict:
    return {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}


def check_launches(name: str, launches: dict, path, exact: dict) -> None:
    """Every kernel of `path` launched (exactly `exact[k]` times where
    given), and no kernel outside it."""
    for k, count in launches.items():
        if k in exact:
            check(count == exact[k],
                  f"{name}: kernel {k} launched {count} times, expected {exact[k]}")
        elif k in path:
            check(count > 0, f"{name}: kernel {k} was not launched on its path")
        else:
            check(count == 0, f"{name}: kernel {k} launched outside its path")


def expected_launches(arch, path, steps: list, layers: tuple | None = None) -> dict:
    """How often one run's path calls the kernels whose count is known
    exactly, given the decoder steps of each batch: the encoder attention
    once per encoder layer and batch, counted by the entry of its body
    family the path holds (`ENCODER_ENTRIES`); the w8a8 matmul for every quantized
    linear (6 an encoder layer, per decoder layer the cross K and V, 6 in
    the prefill and 6 a step); the cache update once per layer and step; the
    grouped cross-attention once per layer for the prefill window and once
    per layer and step, but in a run at small batch for the prefill window
    alone: there the one-query cross-attention takes the steps. `layers`:
    the (encoder, decoder) layer counts as the tree holds them, else the
    arch's."""
    enc_layers, layers = layers or (arch.encoder_layers, arch.decoder_layers)
    n, total = len(steps), sum(steps)
    exact = {k: enc_layers * n if k in path else 0 for k in ENCODER_ENTRIES}
    for k in path:
        if k.startswith("decode_self_attention_update"):
            exact[k] = layers * total
        if k.startswith("decode_cross_attention_grouped"):
            exact[k] = layers * (n + total)
    for k in path:
        if k.startswith("w8a8_matmul"):
            exact[k] = n * (6 * enc_layers + 8 * layers) + 6 * layers * total
        if k.startswith("decode_cross_attention") and "grouped" not in k:
            exact[k] = layers * total
            exact[k.replace("attention", "attention_grouped")] = layers * n
    return exact


def prompt_window(arch, seed: int, batch: int):
    """Seeded right-aligned prompts: (batch, PROMPT_W) text-token ids, the
    left padding holding EOT, and their lengths mixed over 4..PROMPT_W."""
    rng = np.random.default_rng(seed)
    lens = 4 + (np.arange(batch) * 5) % (PROMPT_W - 3)
    prompt = rng.integers(1000, 20000, (batch, PROMPT_W))
    prompt[np.arange(PROMPT_W)[None, :] < (PROMPT_W - lens)[:, None]] = arch.eos_token_id
    return torch.from_numpy(prompt), torch.from_numpy(lens.astype(np.int32))


def expected_prompt_launches(arch, cfg, p_len: int, batches: int,
                             dtype=torch.bfloat16) -> dict:
    """How often one prompt run's path calls each attention kernel, the
    tree's activations being of `dtype`: the encoder attention once per
    encoder layer (in the entry of its type); per decoder layer the prefill
    window in launches of at most 8 slots and one grouped launch per step
    (of beam_size slots), one cache update per step, and the cross-KV
    quantization of K and V."""
    fp = {torch.bfloat16: "", torch.float32: "_f32", torch.float16: "_f16"}[dtype]
    cross = "decode_cross_attention_grouped" + (
        "_int4" if cfg.cross_kv_int4 else "_int8" if cfg.cross_kv_int8 else fp)
    update = "decode_self_attention_update" + ("_int8" if cfg.kv_int8 else fp)
    window = PROMPT_W + p_len - 1
    chunks = [min(8, window - j0) for j0 in range(0, window, 8)]
    wide = sum(c > 4 for c in chunks) + NEW_TOKENS * (cfg.beam_size > 4)
    narrow = sum(c <= 4 for c in chunks) + NEW_TOKENS * (cfg.beam_size <= 4)
    layers = arch.decoder_layers
    exact = {"log_mel_cuda": 1, "encoder_attention" + fp: arch.encoder_layers,
             cross + "_wide": layers * wide, cross: layers * narrow,
             update + "_start": layers * NEW_TOKENS}
    if cfg.cross_kv_int8 and not cfg.cross_kv_int4:
        exact["transpose_quant_kv"] = 2 * layers
    return {k: n * batches for k, n in exact.items()}


@torch.inference_mode()
def rescore(params, arch, cfg, enc, seqs, prompt, lens, first_gen: int):
    """Summed logprob of seqs[:, first_gen: first_gen + NEW_TOKENS] under
    teacher forcing, one row per sequence (enc, prompt and lens hold that
    row's utterance), through the greedy step with cfg's caches and
    suppressions."""
    from openai_whisper_compression_tpu_torch.models import decode

    cfg1 = dataclasses.replace(cfg, beam_size=1)
    cross_kvs, cache, tokens, start, fg, _ = decode._prepare(
        params, arch, enc, cfg1, None, prompt, lens)
    check(fg == first_gen, "rescoring starts at another position")
    logits_fn, _ = decode._logits_fn(params, arch, cfg1, cross_kvs, start, fg, 1,
                                     enc.device)
    last_ts = torch.zeros(enc.shape[0], dtype=torch.long, device=enc.device)
    total = torch.zeros(enc.shape[0], dtype=torch.float32, device=enc.device)
    for pos in range(fg - 1, fg - 1 + NEW_TOKENS):
        logp = torch.log_softmax(logits_fn(seqs, cache, pos, last_ts).float(), -1)
        total += logp.gather(1, seqs[:, pos + 1: pos + 2])[:, 0]
    return total


def run_prompt_path(dev, arch, params, run, profile: bool = False) -> dict:
    """One prompt-conditioned phase-2 run (see PROMPT_RUNS): mel, encoder,
    then `beam_decode` or `greedy_decode` with a left-padded prompt window;
    exact launch counts, the output contract, and the run's own checks
    (`profile`: one more batch under torch.profiler)."""
    from openai_whisper_compression_tpu_torch.audio.features import preprocess
    from openai_whisper_compression_tpu_torch.config import DecodeConfig
    from openai_whisper_compression_tpu_torch.models import decode
    from openai_whisper_compression_tpu_torch.models.whisper import encode

    name, switches, batch, method = (*run, "int8")[:4]
    dtype = params["encoder"]["ln"]["g"].dtype
    eot = arch.eos_token_id
    cfg = DecodeConfig(max_new_tokens=NEW_TOKENS, suppress_tokens=(eot,), **switches)
    beam = cfg.beam_size
    prefix = decode.forced_prefix(arch, cfg)
    first_gen = PROMPT_W + len(prefix)
    log(f"phase2 {name}: {arch.name}, {method} weights, batch {batch}, prompt window "
        f"{PROMPT_W}, prefix {prefix}, {json.dumps(switches)}")
    n_batches = 2
    wavs = [torch.from_numpy(waveforms(SEED + 10 + i, batch)).to(dev)
            for i in range(n_batches)]
    prompt, lens = (t.to(dev) for t in prompt_window(arch, SEED, batch))

    @torch.inference_mode()
    def transcribe(wav, prompt, lens):
        mel = preprocess(wav, arch.num_mel_bins, dft_dtype=torch.bfloat16)
        enc = encode(params, arch, mel.to(dtype), fast_gelu=True)
        fn = decode.beam_decode if beam > 1 else decode.greedy_decode
        return enc, fn(params, arch, enc, cfg, prompt_tokens=prompt, prompt_lens=lens)

    counters = zero_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    walls, outs = [], []
    for wav in wavs:
        t0 = time.perf_counter()
        enc, (tokens, lengths) = transcribe(wav, prompt, lens)
        tokens, lengths = tokens.cpu(), lengths.cpu()   # the timing fence
        walls.append(time.perf_counter() - t0)
        outs.append((tokens, lengths))
        log(f"phase2 {name} batch {len(walls) - 1}: wall {walls[-1]:.4f} s, "
            f"{batch / walls[-1]:.2f} utt/s, RTFx {batch * AUDIO_S / walls[-1]:.2f}")
    launches = read_launches(counters)
    peak_mb = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    log(f"phase2 {name} launches {json.dumps(launches)}")
    log(f"phase2 {name} peak memory {peak_mb:.1f} MiB "
        "(torch.cuda.max_memory_allocated)")
    exact = expected_prompt_launches(arch, cfg, len(prefix), n_batches, dtype)
    check_launches(name, launches,
                   set(exact) | ({"int8_matmul"} if method == "int8" else set()), exact)

    ts_begin = arch.no_timestamps_token_id + 1
    for tokens, lengths in outs:
        check(tokens.shape == (batch, 64), f"tokens shape {tuple(tokens.shape)}")
        check(int(tokens.min()) >= 0 and int(tokens.max()) < arch.vocab_size,
              "tokens outside the vocabulary")
        check(torch.equal(tokens[:, :PROMPT_W], prompt.cpu()), "prompt window not intact")
        check(torch.equal(tokens[:, PROMPT_W: first_gen],
                          torch.tensor(prefix).expand(batch, -1)),
              "forced prefix not intact")
        check(bool((lengths == first_gen + NEW_TOKENS).all()),
              f"lengths {lengths.tolist()}")
        gen = tokens[:, first_gen: first_gen + NEW_TOKENS]
        check(not bool((gen == eot).any()), "EOT emitted although suppressed")
        check(bool((tokens[:, first_gen + NEW_TOKENS:] == eot).all()),
              "tokens past the length must be EOT")
        if not cfg.notimestamps:   # the timestamp rules
            check(bool(((gen[:, 0] >= ts_begin) & (gen[:, 0] <= ts_begin
                        + cfg.max_initial_timestamp_index)).all()),
                  f"first tokens {gen[:, 0].tolist()} are not early timestamps")
            check(not bool((gen == arch.no_timestamps_token_id).any()),
                  "<|notimestamps|> was sampled")
            for row in gen.tolist():
                stamps = [t for t in row if t >= ts_begin]
                check(stamps == sorted(stamps), f"timestamps decrease: {stamps}")
                runs = "".join("t" if t >= ts_begin else "w" for t in row)
                check("ttt" not in runs, f"three timestamps in a row: {runs}")
    if not cfg.notimestamps:
        n_ts = int((outs[0][0][:, first_gen: first_gen + NEW_TOKENS] >= ts_begin).sum())
        log(f"phase2 {name} timestamp rules hold; {n_ts} timestamps among "
            f"{batch * NEW_TOKENS} tokens of batch 0")

    # a left-padded row equals the same row run alone with its unpadded prompt
    with torch.inference_mode():
        rows = [int(i) for i in (lens.argmin(), lens.argmax())]
        full = decode.first_step_logits(params, arch, enc, cfg, prompt, lens)[::beam]
        for i in rows:
            n = int(lens[i])
            alone = decode.first_step_logits(params, arch, enc[i: i + 1], cfg,
                                             prompt[i: i + 1, PROMPT_W - n:])[0]
            rel = float((full[i] - alone).norm() / alone.norm())
            log(f"phase2 {name} row {i} (prompt length {n}) padded vs alone "
                f"first-step logits: relative L2 {rel:.4g} (bound {PROMPT_ROW_REL_L2})")
            check(rel <= PROMPT_ROW_REL_L2,
                  f"{name}: padded row {i} off by {rel:.4g} from the row alone")

    if beam > 1:   # all five beams of two utterances, rescored by teacher forcing
        with torch.inference_mode():
            sub = slice(0, 2)
            seqs, scores, gen_len, fg = decode._beam_search(
                params, arch, enc[sub], cfg, None, prompt[sub], lens[sub])
            best_t, best_l = decode.beam_decode(params, arch, enc[sub], cfg,
                                                prompt_tokens=prompt[sub],
                                                prompt_lens=lens[sub])
            again = rescore(params, arch, cfg, enc[sub].repeat_interleave(beam, 0),
                            seqs, prompt[sub].repeat_interleave(beam, 0),
                            lens[sub].repeat_interleave(beam), fg)
        adj = (scores / gen_len.float() ** cfg.length_penalty).reshape(2, beam)
        adj_again = (again / gen_len.float() ** cfg.length_penalty).reshape(2, beam)
        for u in range(2):
            pick = int(adj[u].argmax())
            check(torch.equal(best_t[u], seqs[u * beam + pick]),
                  f"{name}: utterance {u} is not its best-scoring beam")
            check(len({tuple(r.tolist()) for r in seqs[u * beam: (u + 1) * beam]})
                  == beam, f"{name}: utterance {u} holds a beam twice")
            worst = float(((again - scores).abs() / scores.abs()).reshape(2, beam)[u].max())
            check(worst <= RESCORE_REL,
                  f"{name}: utterance {u} beam scores off by {worst:.4g} of "
                  "their teacher-forced rescoring")
            slack = RESCORE_REL * float(adj_again[u].abs().max())
            check(float(adj_again[u, pick]) >= float(adj_again[u].max()) - slack,
                  f"{name}: utterance {u}'s beam is not the best when rescored")
            log(f"phase2 {name} utterance {u}: beam scores "
                f"{[round(float(x), 2) for x in scores[u * beam: (u + 1) * beam]]}, "
                f"rescored {[round(float(x), 2) for x in again[u * beam: (u + 1) * beam]]} "
                f"(off by at most {worst:.4g} of the score, bound {RESCORE_REL}); "
                f"returned beam {pick}")
    summary = {"batch": batch, "walls_s": walls,
               "rtfx_steady": batch * AUDIO_S / walls[-1],
               "peak_mib": peak_mb, "launches": launches}
    log(f"phase2 {name} batch 1 RTFx {summary['rtfx_steady']:.2f}")
    if profile:
        profile_batch(name, lambda: transcribe(wavs[-1], prompt, lens)[1][0].cpu())
    return summary


def run_path(dev, arch, params, run, profile: bool) -> dict:
    """One phase-2 run (see RUNS): its batches, checks, walls, steady RTFx,
    peak memory, stored weight size and the launch count of every kernel
    over the run."""
    from openai_whisper_compression_tpu_torch.config import DecodeConfig
    from openai_whisper_compression_tpu_torch.evaluation.harness import (
        make_transcribe_fn)
    from openai_whisper_compression_tpu_torch.models.params import size_in_mb

    name, _, method, switches, batch, n_sup, eot_batch, path = run
    eot = arch.eos_token_id
    weights_mib = size_in_mb(params)
    log(f"phase2 {name}: {arch.name}, {method} weights, stored {weights_mib:.1f} "
        f"MiB (size_in_mb), batch {batch}, {json.dumps(switches)}")
    p_len = 4  # <|sot|> <|en|> <|transcribe|> <|notimestamps|>
    prefix = torch.tensor([arch.decoder_start_token_id, arch.language_en_token_id,
                           arch.task_transcribe_token_id,
                           arch.no_timestamps_token_id])

    def make(**kw):
        return make_transcribe_fn(arch, DecodeConfig(max_new_tokens=25, **switches,
                                                     **kw),
                                  fast_mel=True, fast_gelu=True, device=dev)

    fn_sup = make(suppress_tokens=(eot,))
    wavs = [torch.from_numpy(waveforms(SEED + i, batch)).to(dev) for i in range(n_sup)]
    counters = zero_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    walls, outs = [], []

    def one(fn, p, wav, what):
        t0 = time.perf_counter()
        tokens, lengths = fn(p, wav)
        tokens, lengths = tokens.cpu(), lengths.cpu()   # the timing fence
        wall = time.perf_counter() - t0
        log(f"phase2 {name} batch {len(walls)} ({what}): wall {wall:.4f} s, "
            f"{batch / wall:.2f} utt/s, RTFx {batch * AUDIO_S / wall:.2f}, "
            f"lengths min {int(lengths.min())} max {int(lengths.max())}")
        walls.append(wall)
        outs.append((tokens, lengths, what))

    for wav in wavs:
        one(fn_sup, params, wav, "EOT suppressed")
    if eot_batch:
        # batch 0's audio again with EOT allowed and made reachable
        params_eot, twin, stops = eot_twin_params(params, outs[0][0], p_len, eot)
        log(f"phase2 {name} EOT twin: token {twin}; batch 0 emitted it first at "
            f"steps {stops} (25: never)")
        one(make(), params_eot, wavs[0], "EOT allowed")
    launches = read_launches(counters)
    peak_mb = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    log(f"phase2 {name} launches {json.dumps(launches)}")
    log(f"phase2 {name} peak memory {peak_mb:.1f} MiB "
        "(torch.cuda.max_memory_allocated)")
    check_launches(name, launches, path, expected_launches(
        arch, path, [int(lengths.max()) - p_len for _, lengths, _ in outs]))

    for tokens, lengths, what in outs:
        check(tokens.shape == (batch, 64), f"tokens shape {tuple(tokens.shape)}")
        check(int(tokens.min()) >= 0 and int(tokens.max()) < arch.vocab_size,
              "tokens outside the vocabulary")
        check(torch.equal(tokens[:, :p_len], prefix.expand(batch, -1)),
              "forced prefix not intact")
        for row, n in zip(tokens, lengths.tolist()):
            check(bool((row[n:] == eot).all()), "tokens past the length must be EOT")
            check(not bool((row[p_len: n - 1] == eot).any()),
                  "EOT inside a row's valid tokens")
        if what == "EOT suppressed":
            check(bool((lengths == p_len + 25).all()), f"lengths {lengths.tolist()}")
            check(not bool((tokens[:, p_len: p_len + 25] == eot).any()),
                  "EOT emitted although suppressed")
    if eot_batch:
        tokens, lengths, _ = outs[-1]
        check(bool(((lengths > p_len) & (lengths <= p_len + 25)).all()),
              f"lengths {lengths.tolist()}")
        for row, n in zip(tokens, lengths.tolist()):
            check(n == p_len + 25 or int(row[n - 1]) == eot,
                  "a row shorter than the limit must end in EOT")
        if batch > 1:
            check(len(set(lengths.tolist())) > 1,
                  f"EOT-allowed rows must stop at different steps: {lengths.tolist()}")
        else:
            check(int(lengths[0]) < p_len + 25, "the EOT-allowed row did not stop early")
        same = sum(torch.equal(tokens[r, p_len: n - 1], outs[0][0][r, p_len: n - 1])
                   for r, n in enumerate(lengths.tolist()))
        log(f"phase2 {name} EOT allowed: lengths {sorted(set(lengths.tolist()))}, "
            f"{int((lengths < p_len + 25).sum())} of {batch} rows stopped early; "
            f"{same} rows equal batch 0 up to their stop")
    steady = walls[1:3] if n_sup >= 3 else walls[:1]
    summary = {"batch": batch, "walls_s": walls,
               "rtfx_steady": batch * AUDIO_S / (sum(steady) / len(steady)),
               "peak_mib": peak_mb, "weights_mib": weights_mib,
               "launches": launches}
    log(f"phase2 {name} steady ({'batches 1-2' if n_sup >= 3 else 'batch 0'}) "
        f"RTFx {summary['rtfx_steady']:.2f}")

    if profile:
        profile_batch(name, lambda: fn_sup(params, wavs[-1])[0].cpu())
    return summary


def device_kernels(events) -> list:
    """The device-side kernel rows of a profiler's `key_averages()`."""
    return [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation]


def profile_batch(name: str, batch) -> None:
    """One batch under torch.profiler: its wall, the summed device time of
    its kernels, the idle share and the kernel table."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        batch()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in device_kernels(events))
    log(f"profile {name}: wall {wall * 1e3:.1f} ms, summed device kernel "
        f"time {dev_us / 1e3:.1f} ms, idle share "
        f"{max(0.0, 1 - dev_us / 1e6 / wall):.3f}")
    log(events.table(sort_by="self_device_time_total", row_limit=30,
                     max_name_column_width=60))


@torch.inference_mode()
def run_self_attention_replay(dev, arch, params, name: str = "self-attn-replay",
                              phase: str = "phase2") -> dict:
    """`decode_self_attention` on the model's own caches. The function has
    no caller in the model (as in the JAX package, whose decode step takes
    the update functions), so this run puts one behind every cache update of
    four greedy decodes of whisper-small at batch 32 (bf16 and int8 caches,
    without and with a left-padded prompt window): on the cache the update
    kernel just wrote, the read-only kernel must return that kernel's output
    bit for bit. Launch counts are exact: layers x steps for each of its
    four bodies (and, past head dim 256, the WIDE bodies' counts: phase 11
    runs it on small-h2's 2-layer cut)."""
    from openai_whisper_compression_tpu_torch.audio.features import preprocess
    from openai_whisper_compression_tpu_torch.config import DecodeConfig
    from openai_whisper_compression_tpu_torch.models import decode
    from openai_whisper_compression_tpu_torch.models.whisper import encode
    from openai_whisper_compression_tpu_torch.ops import self_attention_step as sas

    batch = BATCH
    log(f"{phase} {name}: {arch.name}, int8 weights, batch {batch}, bf16 and int8 "
        "caches, without and with a prompt window")

    def replayed(update, int8: bool):
        def fn(q, k_new, v_new, k_cache, v_cache, *rest, start=None):
            out = update(q, k_new, v_new, k_cache, v_cache, *rest, start=start)
            scales = dict(zip(("k_scale", "v_scale"), rest[:2])) if int8 else {}
            again = sas.decode_self_attention(q, k_cache, v_cache, rest[-1],
                                              start=start, **scales)
            check(torch.equal(again, out),
                  f"{name}: decode_self_attention differs from {update.__name__} "
                  f"at position {rest[-1]} (max {max_err(again, out)})")
            return out
        return fn

    wav = torch.from_numpy(waveforms(SEED, batch)).to(dev)
    prompt, lens = (t.to(dev) for t in prompt_window(arch, SEED, batch))
    originals = (decode.decode_self_attention_update,
                 decode.decode_self_attention_update_int8)
    decode.decode_self_attention_update = replayed(originals[0], False)
    decode.decode_self_attention_update_int8 = replayed(originals[1], True)
    try:
        counters = zero_launches()
        t0 = time.perf_counter()
        mel = preprocess(wav, arch.num_mel_bins, dft_dtype=torch.bfloat16)
        enc = encode(params, arch, mel.to(torch.bfloat16), fast_gelu=True)
        for kv_int8 in (False, True):
            cfg = DecodeConfig(max_new_tokens=NEW_TOKENS, kv_int8=kv_int8,
                               suppress_tokens=(arch.eos_token_id,))
            for kw in ({}, {"prompt_tokens": prompt, "prompt_lens": lens}):
                tokens, lengths = decode.greedy_decode(params, arch, enc, cfg, **kw)
                first = (PROMPT_W if kw else 0) + len(decode.forced_prefix(arch, cfg))
                check(bool((lengths == first + NEW_TOKENS).all())
                      and int(tokens.max()) < arch.vocab_size,
                      f"{name}: lengths {lengths.tolist()}")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        (decode.decode_self_attention_update,
         decode.decode_self_attention_update_int8) = originals
    launches = read_launches(counters)
    log(f"{phase} {name} launches {json.dumps(launched(launches))}")
    per_decode = arch.decoder_layers * NEW_TOKENS
    exact = {"log_mel_cuda": 1, "encoder_attention": arch.encoder_layers}
    for suffix in ("", "_start", "_int8", "_int8_start"):
        exact["decode_self_attention" + suffix] = per_decode
        exact["decode_self_attention_update" + suffix] = per_decode
    path = set(exact) | {"int8_matmul", "decode_cross_attention_grouped",
                         "decode_cross_attention_grouped_wide"}
    if arch.head_dim > 256:   # every attention launch a WIDE body's
        exact.update({"encoder_attention_wide_dh": arch.encoder_layers,
                      "decode_self_attention_wide_dh": 4 * per_decode,
                      "decode_self_attention_update_wide_dh": 2 * per_decode,
                      "decode_self_attention_update_int8_wide_dh": 2 * per_decode})
        path |= set(exact) | {"decode_cross_attention_grouped_wide_dh"}
    check_launches(name, launches, path, exact)
    log(f"{phase} {name}: {4 * per_decode} read-only calls equal to the update "
        f"kernels' outputs bit for bit; wall {wall:.2f} s")
    return {"batch": batch, "walls_s": [wall], "launches": launches}


# ---------------------------------------------------------------------------
# Slice 11: the evaluation entry point, the full-sequence decoder, the
# unfused step, token merging and the temperature ladder
# ---------------------------------------------------------------------------

# - the tie rule: where two decodes of one utterance part, the tokens are a
#   fault unless both lie, in a CPU f32 recompute of the logits at the first
#   divergent position (teacher-forced on the common prefix), within
#   TIE_REL x the RMS of the logits of the tokens not suppressed of the top
#   logit: the per-logit share of phase 3's relative L2 bound,
#   LOGITS_REL_L2. A layout or indexing fault moves a token far below the
#   top.
TIE_REL = LOGITS_REL_L2
# - nll_loss on the card (bf16) against the CPU (f32): a mean of 32
#   log-softmax terms of logits held to LOGITS_REL_L2; 1e-2 relative.
NLL_REL = 1e-2
EVAL_BATCH = HEAD_BATCH
# merge-pool configurations at BATCH: (name, make_transcribe_fn keywords,
# DecodeConfig switches, kernels of the path)
MERGE_RUNS = [
    ("merge-at6", {"merge_at": 6, "merge_factor": 2}, KV8, DECODE_KERNELS),
    ("pool2-ckv8", {}, {"cross_kv_pool": 2, **KV8}, DECODE_KERNELS),
    ("tome300-bf16", {}, {"cross_kv_merge": 300},
     ("log_mel_cuda", "encoder_attention", "int8_matmul",
      "decode_cross_attention_grouped", "decode_self_attention_update")),
]
# kernels-line entries for the shapes only the merge-pool runs give their
# kernels: (entry name, the KERNELS entry, the run whose launch count it
# reports and whose call it times, the shape key of `checked_kernel_calls`,
# the result key)
SHAPE_ENTRIES = [
    ("encoder_attention@T750", "encoder_attention", "merge-at6",
     ("encoder_attention", 12, 750), "enc_attn_t750"),
    ("transpose_quant_kv@S750", "transpose_quant_kv", "pool2-ckv8",
     ("transpose_quant_kv", 750, 768), "tq_s750"),
    ("decode_cross_attention_grouped_int8@S750", "decode_cross_attention_grouped_int8",
     "pool2-ckv8", ("grouped", "torch.int8", 750, 1, 384), "cross_int8_s750"),
    ("decode_cross_attention_grouped@S1200", "decode_cross_attention_grouped",
     "tome300-bf16", ("grouped", "torch.bfloat16", 1200, 1, 384), "cross_s1200"),
]


NEG_INF = -1e9   # the decode's additive suppression (models.whisper.NEG_INF)


def cpu_enc(params_cpu, arch, wav: torch.Tensor, fast: bool = True, device="cpu",
            **encode_kw) -> torch.Tensor:
    """f32 encoder states of waveforms, on the CPU (or `device`, where the
    tree lives): with `fast` the card runs' frontend and encoder options
    (bf16 DFT mel, tanh GELU), without it the f32 DFT and the exact GELU
    (the streaming step's)."""
    from openai_whisper_compression_tpu_torch.audio.features import preprocess
    from openai_whisper_compression_tpu_torch.evaluation.harness import samples_for_arch
    from openai_whisper_compression_tpu_torch.models.whisper import encode

    mel = preprocess(wav.to(device), arch.num_mel_bins, length=samples_for_arch(arch),
                     dft_dtype=torch.bfloat16 if fast else torch.float32)
    return encode(params_cpu, arch, mel.float(), fast_gelu=fast, **encode_kw)


class TeacherForced:
    """One row teacher-forced through the greedy step with cfg's caches,
    cross-KV, suppressions and timestamp rules (the last timestamp of the
    forced tokens carried as greedy carries it), after the prompt window
    `prompt` (1, P) of length `lens` (1,) when given, along `seq`, in f32
    on the device the tree and `enc_row` live on. `at(div)` steps on as far
    as position `div` and returns its logits (V,); every position's logits
    are kept, so later calls for the same row cost only the steps past the
    last. The logits at `div` depend on seq[:div] alone, so one walk along
    a reference row serves every row that agrees with it before `div`."""

    def __init__(self, params, arch, cfg, enc_row: torch.Tensor, seq: torch.Tensor,
                 prompt: torch.Tensor | None = None, lens: torch.Tensor | None = None):
        from openai_whisper_compression_tpu_torch.models import decode

        cfg1 = dataclasses.replace(cfg, beam_size=1)
        dev = enc_row.device
        self.cross_kvs, self.cache, _, start, self.fg, _ = decode._prepare(
            params, arch, enc_row, cfg1, None,
            None if prompt is None else prompt.to(dev), None if lens is None else lens.to(dev))
        self.fn, _ = decode._logits_fn(params, arch, cfg1, self.cross_kvs, start, self.fg,
                                       1, dev)
        self.seq = seq.cpu()
        self.seqs = seq[None].to(dev)
        self.ts_begin = arch.no_timestamps_token_id + 1
        self.last_ts = torch.zeros(1, dtype=torch.long, device=dev)
        self.pos, self.logits = self.fg - 1, {}

    def at(self, div: int) -> torch.Tensor:
        while self.pos < div:
            pos = self.pos
            self.logits[pos + 1] = self.fn(self.seqs, self.cache, pos, self.last_ts)[0].float()
            if int(self.seq[pos + 1]) >= self.ts_begin:
                self.last_ts = self.seqs[0, pos + 1: pos + 2].clone()
            self.pos += 1
        return self.logits[div]



@torch.inference_mode()
def check_ties(name: str, params_cpu, arch, cfg, wav: torch.Tensor, got: torch.Tensor,
               want: torch.Tensor, first_gen: int, encode_kw: dict | None = None,
               prompt: torch.Tensor | None = None, lens: torch.Tensor | None = None,
               encs: dict | None = None, fast: bool = True, walks: dict | None = None,
               device="cpu") -> int:
    """Rows of `got` and `want` (B, L), decodes of the same waveforms `wav`
    (after the prompt window `prompt` (B, P) of lengths `lens` when given),
    equal, or parted at a proven tie (TIE_REL) in an f32 recompute on the
    CPU (or on `device`, where `params_cpu` lives): returns the rows that
    parted. `encs`: f32 encoder states by row of `wav`, filled and reused
    across calls on one batch; `fast`: the frontend of `cpu_enc`. `walks`:
    the rows' teacher-forced walks along `want` (`TeacherForced`), shared by
    calls that hold different decodes against the same `want`, tree, cfg
    and prompt window; a parted row's prefix before `div` is want's, so the
    walk along want gives its logits there."""
    rows = [r for r in range(got.shape[0]) if not torch.equal(got[r], want[r])]
    if not rows:
        return 0
    encs = {} if encs is None else encs
    walks = {} if walks is None else walks
    todo = [r for r in rows if r not in encs]
    if todo:
        for r, e in zip(todo, cpu_enc(params_cpu, arch, wav[todo], fast, device=device,
                                      **(encode_kw or {}))):
            encs[r] = e[None]
    for r in rows:
        a, b = got[r].cpu(), want[r].cpu()
        div = int(torch.nonzero(a != b)[0, 0])
        check(div >= first_gen, f"{name}: row {r} parts inside its forced prefix")
        if r not in walks:
            pr = None if prompt is None else (prompt[r: r + 1], lens[r: r + 1])
            walks[r] = TeacherForced(params_cpu, arch, cfg, encs[r], b, *(pr or ()))
        check(torch.equal(walks[r].seq, b), f"{name}: row {r}'s walk follows another row")
        logits = walks[r].at(div)
        top = float(logits.max())
        gap = max(top - float(logits[int(a[div])]), top - float(logits[int(b[div])]))
        live = logits[logits > NEG_INF / 2]   # not the suppressed tokens
        limit = TIE_REL * float(live.pow(2).mean().sqrt())
        log(f"{name}: row {r} parts at position {div} ({int(a[div])} vs "
            f"{int(b[div])}): {'CPU' if str(device) == 'cpu' else 'card'} f32 gap to the "
            f"top logit {gap:.4g} (tie bound "
            f"{limit:.4g})")
        check(gap <= limit, f"{name}: row {r} parts at position {div} with an "
              f"f32 gap {gap:.4g} > {limit:.4g}: not a tie")
    return len(rows)


@torch.inference_mode()
def run_eval_headline(dev, arch, params) -> dict:
    """`evaluate_model` at bench.py's headline decode (int8 weights, fused
    qkv, int8 self-KV and cross-KV, 25 new tokens, EOT suppressed) over
    `synthetic_dataset(2 x 96)`: one warmup batch, then two batches of 96
    (length-bucketed), `WordTokenizer`, a `MemoryTracker`. Exact launch
    counts for the three batches; every batch's texts equal to the
    tokenizer's decode of `make_transcribe_fn`'s tokens for that padded
    batch, called directly."""
    from openai_whisper_compression_tpu_torch.config import DecodeConfig, EvalConfig
    from openai_whisper_compression_tpu_torch.evaluation.data import synthetic_dataset
    from openai_whisper_compression_tpu_torch.evaluation.harness import (
        evaluate_model, make_transcribe_fn, samples_for_arch)
    from openai_whisper_compression_tpu_torch.evaluation.memory import (
        MemoryTracker, analytic_hbm_mb)
    from openai_whisper_compression_tpu_torch.evaluation.tokenizer import (
        default_tokenizer)

    name, bs = "eval-headline", EVAL_BATCH
    cfg = DecodeConfig(max_new_tokens=NEW_TOKENS, suppress_tokens=(arch.eos_token_id,),
                       **KV8)
    fn = make_transcribe_fn(arch, cfg, fast_mel=True, fast_gelu=True, device=dev)
    dataset = synthetic_dataset(2 * bs, seed=0)
    tok = default_tokenizer(arch)
    tracker = MemoryTracker(f"{arch.name}-int8")
    log(f"phase4 {name}: {arch.name}, int8 weights, fused qkv, int8 self-KV and "
        f"cross-KV, batch {bs}, synthetic_dataset({2 * bs}, seed=0) "
        f"({sum(u.duration for u in dataset):.2f} s of audio), one warmup batch")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    before_mib = torch.cuda.memory_allocated(dev) / 2 ** 20
    counters = zero_launches()
    t0 = time.perf_counter()
    scores, records = evaluate_model(
        params, arch, dataset, tok, eval_cfg=EvalConfig(batch_size=bs, warmup_batches=1),
        decode_cfg=cfg, memory_tracker=tracker, transcribe_fn=fn)
    wall = time.perf_counter() - t0
    launches = read_launches(counters)
    log(f"phase4 {name} launches {json.dumps(launches)}")
    batches = 3   # the warmup and two batches of 96
    steps = [NEW_TOKENS] * batches
    exact = expected_launches(arch, DECODE_KERNELS, steps)
    exact.update({"log_mel_cuda": batches, "transpose_quant_kv": 2 * arch.decoder_layers
                  * batches, "int8_matmul": 6 * arch.decoder_layers * (NEW_TOKENS + 1)
                  * batches})
    check_launches(name, launches, ("int8_matmul",) + DECODE_KERNELS, exact)

    # every batch's texts against the transcription function called directly
    n = samples_for_arch(arch)
    by_id = {r["id"]: r["hypothesis"] for r in records}
    check(len(records) == 2 * bs and [r["id"] for r in records] == [u.uid for u in dataset],
          f"{name}: records not in input order")
    bucketed = sorted(dataset, key=lambda u: u.duration)
    for bi in range(2):
        batch = bucketed[bi * bs: (bi + 1) * bs]
        wav = np.zeros((bs, n), np.float32)
        for i, u in enumerate(batch):
            wav[i, : min(len(u.audio), n)] = u.audio[:n]
        tokens, lengths = fn(params, torch.from_numpy(wav).to(dev))
        tokens, lengths = tokens.cpu(), lengths.cpu()
        check(bool((lengths == 4 + NEW_TOKENS).all()), f"{name}: lengths {lengths.tolist()}")
        for i, u in enumerate(batch):
            text = tok.decode(tokens[i, : lengths[i]].tolist())
            check(by_id[u.uid] == text, f"{name}: batch {bi} row {i}: evaluate_model's "
                  f"text differs from the direct call's")
    mem = scores["memory"]
    peak = mem["hbm_peak_mb"]["max"]
    analytic = analytic_hbm_mb(params, arch, bs, kv_int8=True, cross_kv_bytes=1.0,
                               cache_len=-(-(NEW_TOKENS + 8) // 64) * 64)
    check(not mem["hbm_analytic"] and peak > 0, f"{name}: no device memory reading")
    check(abs(analytic - tracker.analytic_mb) < 1e-6, f"{name}: analytic model differs")
    lat = scores["batch_latencies_s"]
    check(scores["num_samples"] == 2 * bs and len(lat) == 2 and scores["rtfx"] > 0
          and 0.0 <= scores["wer"] and scores["cer"] is not None,
          f"{name}: scores {scores}")
    log(f"phase4 {name}: RTFx {scores['rtfx']:.2f} ({scores['total_audio_duration_s']:.2f} "
        f"s of audio in {scores['total_processing_time_s']:.4f} s), batch latency mean "
        f"{scores['avg_latency_per_batch_s']:.4f} s (first {lat[0]:.4f} s, then "
        f"{', '.join(f'{x:.4f}' for x in lat[1:])} s); peak memory {peak:.1f} MiB "
        f"(torch allocator, hbm_peak_mb; {before_mib:.1f} MiB of it in use before "
        f"the run: the weights) beside the analytic {analytic:.1f} MiB "
        f"(analytic_hbm_mb); WER {scores['wer']:.4f} CER {scores['cer']:.4f} "
        f"(seeded weights: these measure the harness, not the model); wall with "
        f"warmup and bookkeeping {wall:.2f} s")
    return {"batch": bs, "walls_s": lat, "rtfx": scores["rtfx"], "peak_mib": peak,
            "analytic_mib": analytic, "launches": launches}


def run_forward_small(dev, arch, params) -> dict:
    """`make_calibration_fn` (4 utterances, 8 tokens teacher-forced from
    `WordTokenizer`) drives `forward` on the card: exact launch counts (the
    mel once, the encoder attention once a layer, the decoder's 72 linears
    at M = 32 through the int8 matmul kernel), every kernel call held
    against its plain version (`checked_kernel_calls`). Then `forward`,
    `decode_logits` and `nll_loss` in bf16 on the card against the same
    calls in f32 on the CPU."""
    from openai_whisper_compression_tpu_torch.audio.features import preprocess
    from openai_whisper_compression_tpu_torch.evaluation.data import synthetic_dataset
    from openai_whisper_compression_tpu_torch.evaluation.harness import (
        make_calibration_fn, samples_for_arch)
    from openai_whisper_compression_tpu_torch.evaluation.tokenizer import (
        default_tokenizer)
    from openai_whisper_compression_tpu_torch.models.params import tree_to
    from openai_whisper_compression_tpu_torch.models.whisper import (
        decode_logits, encode, forward, nll_loss)

    name, b, n_tok = "forward-small", 2, 8
    cal = synthetic_dataset(b, seed=1)
    tok = default_tokenizer(arch)
    log(f"phase4 {name}: {arch.name}, int8 weights, make_calibration_fn batch {b}, "
        f"{n_tok} tokens teacher-forced")
    run = make_calibration_fn(arch, cal, tok, batch_size=b, n_tokens=n_tok, device=dev)
    shapes: dict = {}
    with checked_kernel_calls(shapes) as held:
        counters = zero_launches()
        with torch.no_grad():
            logits = run(params)
        torch.cuda.synchronize()
        launches = read_launches(counters)
    log(f"phase4 {name} launches {json.dumps(launches)}; {held_summary(held, shapes)}")
    check_launches(name, launches, ("log_mel_cuda", "encoder_attention", "int8_matmul"),
                   {"log_mel_cuda": 1, "encoder_attention": arch.encoder_layers,
                    "int8_matmul": 6 * arch.decoder_layers})

    n = samples_for_arch(arch)
    wav = np.zeros((b, n), np.float32)
    toks = np.full((b, n_tok), arch.eos_token_id, np.int64)
    toks[:, 0] = arch.decoder_start_token_id
    for i, u in enumerate(cal):
        wav[i, : min(len(u.audio), n)] = u.audio[:n]
        ids = tok.encode(u.text)[: n_tok - 1]
        toks[i, 1: 1 + len(ids)] = ids
    labels = np.roll(toks, -1, axis=1)
    lmask = np.ones((b, n_tok), np.float32)
    lmask[:, -1] = 0.0

    def calls(p, device, dtype):
        w, t = torch.from_numpy(wav).to(device), torch.from_numpy(toks).to(device)
        mel = preprocess(w, arch.num_mel_bins, length=n).to(dtype)
        with torch.no_grad():
            enc = encode(p, arch, mel)
            return {"forward": forward(p, arch, mel, t).float().cpu(),
                    "decode_logits": decode_logits(p, arch, t, enc).float().cpu(),
                    "nll_loss": nll_loss(p, arch, mel, t, torch.from_numpy(labels).to(device),
                                         torch.from_numpy(lmask).to(device)).float().cpu()}

    with checked_kernel_calls({}):
        card = calls(params, dev, torch.bfloat16)
    check(torch.equal(card["forward"], logits.float().cpu()),
          f"{name}: forward differs from the calibration call's logits")

    def compare(params_cpu):
        t0 = time.perf_counter()
        ref = calls(params_cpu, "cpu", torch.float32)
        cpu_s = time.perf_counter() - t0
        for k in ("forward", "decode_logits"):
            c, r = card[k], ref[k]
            rel = float((c - r).norm() / r.norm())
            log(f"phase4 {name} {k} {tuple(c.shape)} card bf16 vs CPU f32: relative L2 "
                f"{rel:.4g} (bound {LOGITS_REL_L2}), max abs {max_err(c, r):.4g}, |logits| "
                f"max {float(r.abs().max()):.4g}")
            check(c.shape == (b, n_tok, arch.vocab_size) and bool(torch.isfinite(c).all())
                  and rel <= LOGITS_REL_L2, f"{name}: {k} off by {rel:.4g} relative L2")
        rel = (abs(float(card["nll_loss"]) - float(ref["nll_loss"]))
               / abs(float(ref["nll_loss"])))
        log(f"phase4 {name} nll_loss card bf16 {float(card['nll_loss']):.6g} vs CPU f32 "
            f"{float(ref['nll_loss']):.6g}: relative {rel:.4g} (bound {NLL_REL}); CPU "
            f"reference {cpu_s:.1f} s")
        check(rel <= NLL_REL, f"{name}: nll_loss off by {rel:.4g} relative")

    later(f"phase4 {name}", functools.partial(compare, tree_to(params, "cpu", torch.float32)))
    return {"batch": b, "launches": launches}


@torch.inference_mode()
def run_unfused_int8(dev, arch, params) -> dict:
    """`greedy_decode` with `cross_pallas=False, self_pallas=False`, int8
    self-KV and cross-KV, batch 32 (through `make_transcribe_fn`): no
    attention kernel of the decode launches (rows 7, 9, 11, 13), the int8
    matmul as often as in the fused run on the same audio, and the tokens
    equal to the fused run's but where a CPU f32 recompute proves a tie.
    Every kernel call of both runs is held against its plain version
    (`checked_kernel_calls`)."""
    from openai_whisper_compression_tpu_torch.config import DecodeConfig
    from openai_whisper_compression_tpu_torch.evaluation.harness import make_transcribe_fn
    from openai_whisper_compression_tpu_torch.models.params import tree_to

    name, b = "unfused-int8", BATCH
    base = dict(max_new_tokens=NEW_TOKENS, suppress_tokens=(arch.eos_token_id,), **KV8)
    cfg_u = DecodeConfig(cross_pallas=False, self_pallas=False, **base)
    wav = torch.from_numpy(waveforms(SEED, b)).to(dev)
    log(f"phase4 {name}: {arch.name}, int8 weights, batch {b}, the unfused step over "
        "int8 self-KV and standard-layout int8 cross-KV")
    runs = {}
    for what, cfg in (("fused", DecodeConfig(**base)), ("unfused", cfg_u)):
        fn = make_transcribe_fn(arch, cfg, fast_mel=True, fast_gelu=True, device=dev)
        shapes: dict = {}
        with checked_kernel_calls(shapes) as held:
            counters = zero_launches()
            t0 = time.perf_counter()
            tokens, lengths = (x.cpu() for x in fn(params, wav))
            wall = time.perf_counter() - t0
            runs[what] = (tokens, lengths, read_launches(counters), wall)
        log(f"phase4 {name} {what}: wall {wall:.4f} s (every kernel call checked), "
            f"launches {json.dumps(runs[what][2])}; {held_summary(held, shapes)}")
    tokens, lengths, launches, wall = runs["unfused"]
    check_launches(name, launches, ("log_mel_cuda", "encoder_attention", "int8_matmul"),
                   {"log_mel_cuda": 1, "encoder_attention": arch.encoder_layers,
                    "int8_matmul": runs["fused"][2]["int8_matmul"]})
    check(torch.equal(lengths, runs["fused"][1]) and bool((lengths == 4 + NEW_TOKENS).all()),
          f"{name}: lengths {lengths.tolist()}")
    summary = {"batch": b, "walls_s": [wall], "launches": launches}
    card_ties(name, tree_to(params, dev, torch.float32), arch, cfg_u, wav, tokens,
              runs["fused"][0], 4, summary,
              lambda p: f"phase4 {name}: {b - p} of {b} rows equal the fused run's "
                        f"tokens, {p} part at a proven tie", encs=SEED_ENCS)
    return summary


@contextlib.contextmanager
def patched(*triples):
    """Set module attributes (module, name, value) for the block's length."""
    old = [(m, n, getattr(m, n)) for m, n, _ in triples]
    for m, n, v in triples:
        setattr(m, n, v)
    try:
        yield
    finally:
        for m, n, v in old:
            setattr(m, n, v)


class DeferredChecks:
    """Kernel-against-plain checks queued behind the work instead of
    draining the device at every call. `close` (an output within KERNEL_REL
    of its plain version's largest magnitude) and `differ` (tensors equal
    bit for bit) queue an error and its bound on the device; `verify` reads
    them back together, every `flush_at` checks and when asked, and fails
    the run at the first whose error is not within its bound: a NaN error
    or bound fails, as a per-call `check(err <= tol)` does. Small outputs
    wait beside their plain versions and are reduced a stack of one shape
    at a time when `stack_at` have gathered."""

    def __init__(self, flush_at: int = 4096, stack_at: int = 512):
        self.flush_at, self.stack_at = flush_at, stack_at
        self.pending: list = []    # (errors, bounds, whats)
        self.queued = 0            # the checks in `pending`
        self.pairs: list = []      # (got, ref, what)

    def _reduce_pairs(self) -> None:
        groups: dict = {}
        for item in self.pairs:
            groups.setdefault((tuple(item[0].shape), item[0].dtype), []).append(item)
        self.pairs.clear()
        for items in groups.values():
            g = torch.stack([x[0] for x in items]).float()
            r = torch.stack([x[1] for x in items]).float()
            dims = tuple(range(1, g.dim()))
            self.pending.append(((g - r).abs().amax(dim=dims),
                                 KERNEL_REL[items[0][1].dtype] * r.abs().amax(dim=dims),
                                 [x[2] for x in items]))
            self.queued += len(items)

    def verify(self) -> None:
        self._reduce_pairs()
        if not self.pending:
            return
        errs = torch.cat([e.float() for e, _, _ in self.pending])
        tols = torch.cat([t.float() for _, t, _ in self.pending])
        whats = [w for _, _, ws in self.pending for w in ws]
        self.pending.clear()
        self.queued = 0
        bad = (~(errs <= tols)).cpu()
        if bool(bad.any()):
            i = int(torch.nonzero(bad)[0, 0])
            check(False, f"{whats[i]}: err {float(errs[i])} > {float(tols[i])}")

    def _defer(self, err, tol, what) -> None:
        self.pending.append((err.reshape(1), tol.reshape(1), [what]))
        self.queued += 1
        if self.queued >= self.flush_at:
            self.verify()

    def differ(self, what, tensors) -> None:
        """Queue a check that each (a, b) of `tensors` is equal bit for bit
        (a NaN on both sides differs)."""
        n = sum((a != b).sum() for a, b in tensors)
        self._defer(n, torch.zeros((), device=n.device), what)

    def close(self, what, got, ref) -> None:
        """Queue a check of `got` against its plain version `ref`."""
        check(got.dtype == ref.dtype, f"{what}: dtype {got.dtype}, plain {ref.dtype}")
        if got.numel() > 1 << 20:   # the encoder's: reduced at once
            r = ref.float()
            self._defer((got.float() - r).abs().max(), KERNEL_REL[ref.dtype] * r.abs().max(),
                        what)
        else:
            self.pairs.append((got, ref, what))
            if len(self.pairs) >= self.stack_at:
                self._reduce_pairs()
                if self.queued >= self.flush_at:
                    self.verify()


class HeldLaunches:
    """The proof that a block held every launch of the kernels it shims.
    `families` maps each shimmed wrapper to its counters ((entry name,
    attribute) of KERNELS). `around(wrapper, call)` runs `call` and adds the
    growth of the wrapper's counters during it to `seen`, returning that
    growth; `fold()` adds every counter's growth since the last fold to
    `total` (`zero_launches` folds the open blocks before it sets the counters
    to 0); `check()` folds and fails the run where a counter grew by more
    than its launches seen inside a shim (a call that reached the kernel
    some other way), returning the launches held."""

    def __init__(self, families: dict):
        import threading

        self.families = families
        self.counters = [(w, n, a) for w, cs in families.items() for n, a in cs]
        self.seen = {n: 0 for _, n, _ in self.counters}
        self.total = dict(self.seen)
        self.base = self._read()
        self.lock = threading.RLock()   # the serving worker's calls beside the caller's

    def _read(self) -> dict:
        return {n: getattr(w, a) for w, n, a in self.counters}

    def around(self, wrapper, call):
        with self.lock:
            cs = self.families[wrapper]
            before = [getattr(wrapper, a) for _, a in cs]
            out = call()
            grown = {n: getattr(wrapper, a) - b for (n, a), b in zip(cs, before)
                     if getattr(wrapper, a) != b}
            for n, d in grown.items():
                self.seen[n] += d
        return out, grown

    def fold(self) -> None:
        with self.lock:
            now = self._read()
            for n, v in now.items():
                self.total[n] += v - self.base[n]
            self.base = {n: 0 for n in now}   # the caller sets the counters to 0 next

    def check(self) -> dict:
        now = self._read()
        for n, v in now.items():
            self.total[n] += v - self.base[n]
        self.base = now
        unheld = {n: (self.total[n], self.seen[n]) for n in self.total
                  if self.total[n] != self.seen[n]}
        check(not unheld, "kernel launches that no shim held, (launched, held inside "
              f"a shim): {unheld}")
        return {n: v for n, v in self.seen.items() if v}


_HELD_BLOCKS: list = []    # the open checked_kernel_calls blocks' HeldLaunches


@contextlib.contextmanager
def checked_kernel_calls(shapes: dict, calls: dict | None = None, mel: bool = False):
    """While open, the model's calls of the encoder attention, the cross-KV
    quantizer, the two cross-attentions, `linear`'s int8, int4, NF4/FP4 and
    w8a8 matmuls (the w8a8 bit for bit) and the two cache updates (with
    `mel`, the log-mel too) go through shims: each call
    launches the kernel (counted by its wrapper as always), then holds the
    result against the plain version on the same inputs (the quantizer's
    codes and scales and the updates' caches bit for bit, every output
    within KERNEL_REL of the reference's largest magnitude, the log-mel no
    further than the plain version + MEL_EXACT_MARGIN from the float64
    log-mel; `DeferredChecks` reads the results back together, so a failure
    surfaces by the block's end). When the block ends, every launch of
    these kernels while it was open must have been made inside a shim
    (`HeldLaunches`: the wrappers' counters against the launches the shims
    saw), so no call reached a kernel unheld. `shapes` gets the first
    call's inputs at every shape; `calls`,
    when given, gets the launches at each shape, per KERNELS entry (a
    grouped call launches once per chunk of at most 8 slots); yields the
    count of calls held, per kernel."""
    from openai_whisper_compression_tpu_torch.audio import features
    from openai_whisper_compression_tpu_torch.models import decode, whisper
    from openai_whisper_compression_tpu_torch.ops import attention as att
    from openai_whisper_compression_tpu_torch.ops import cross_attention as ca
    from openai_whisper_compression_tpu_torch.ops import linear as lin
    from openai_whisper_compression_tpu_torch.ops import quant_matmul as qm
    from openai_whisper_compression_tpu_torch.ops import self_attention_step as sas

    held: dict = {}
    checks = DeferredChecks()
    wrappers = [att.encoder_attention, ca.transpose_quant_kv,
                ca.decode_cross_attention_grouped, ca.decode_cross_attention,
                qm.int8_matmul, qm.int4_matmul, qm.nf4_matmul, qm.w8a8_matmul,
                sas.decode_self_attention_update, sas.decode_self_attention_update_int8]
    if mel:   # last: the frontend's shim launches through wrappers[-1]
        from openai_whisper_compression_tpu_torch.audio import mel_kernel
        wrappers.append(mel_kernel.log_mel_cuda)
    counters = launch_counters()
    ledger = HeldLaunches({w: [(n, a) for n, (f, a) in counters.items() if f is w]
                           for w in wrappers})

    def launch(wrapper, key, call):
        out, grown = ledger.around(wrapper, call)
        check(grown, f"{wrapper.__name__} at {key}: a held call launched no kernel")
        if calls is not None and key is not None:
            at = calls.setdefault(key, {})
            for n, d in grown.items():
                at[n] = at.get(n, 0) + d
        return out

    def close(what, got, ref):
        checks.close(what, got, ref)
        kernel = what.split()[0]
        held[kernel] = held.get(kernel, 0) + 1

    def keep(key, *args):   # the first call's inputs at each shape
        if key not in shapes:
            shapes[key] = tuple(a.clone() if isinstance(a, torch.Tensor) else a
                                for a in args)

    def enc_attn(q, k, v):
        key = ("encoder_attention", q.shape[1], q.shape[2])
        out = launch(att.encoder_attention, key, lambda: att.encoder_attention(q, k, v))
        close(f"encoder_attention {tuple(q.shape)}", out, att.encoder_attention_ref(q, k, v))
        if key not in shapes:                   # views, as the model hands them over
            shapes[key] = (q, k, v)
        return out

    def tq(x, h):
        key = ("transpose_quant_kv", x.shape[1], x.shape[2])
        q, sc = launch(ca.transpose_quant_kv, key, lambda: ca.transpose_quant_kv(x, h))
        q_ref, sc_ref = ca.transpose_quant_kv_ref(x, h)
        checks.differ(f"transpose_quant_kv {tuple(x.shape)}: codes or scales differ",
                      ((q, q_ref), (sc, sc_ref)))
        held["transpose_quant_kv"] = held.get("transpose_quant_kv", 0) + 1
        keep(key, x, h)
        return q, sc

    def grouped(q, k_t, v_t, k_scale=None, v_scale=None, s_valid=None):
        key = ("grouped", str(k_t.dtype), s_valid, q.shape[1], q.shape[0])
        out = launch(ca.decode_cross_attention_grouped, key,
                     lambda: ca.decode_cross_attention_grouped(q, k_t, v_t, k_scale,
                                                               v_scale, s_valid))
        close(f"decode_cross_attention_grouped {tuple(k_t.shape)} s_valid {s_valid}",
              out, ca.decode_cross_attention_grouped_ref(q, k_t, v_t, k_scale,
                                                         v_scale, s_valid))
        if key not in shapes:
            shapes[key] = (q.clone(), (k_t, v_t, k_scale, v_scale), s_valid)
        return out

    def one_query(q, k_t, v_t, k_scale=None, v_scale=None, s_valid=None):
        key = ("one_query", str(k_t.dtype), s_valid, q.shape[0])
        out = launch(ca.decode_cross_attention, key,
                     lambda: ca.decode_cross_attention(q, k_t, v_t, k_scale, v_scale, s_valid))
        close(f"decode_cross_attention {tuple(k_t.shape)} s_valid {s_valid}", out,
              ca.decode_cross_attention_ref(q, k_t, v_t, k_scale, v_scale, s_valid))
        if key not in shapes:
            shapes[key] = (q.clone(), (k_t, v_t, k_scale, v_scale), s_valid)
        return out

    def weight_only(kernel, plain):   # the int8, int4 and NF4/FP4 matmuls
        def mm(x, w, *args):
            key = (kernel.__name__, *x.shape, w.shape[1])
            out = launch(kernel, key, lambda: kernel(x, w, *args))
            close(f"{kernel.__name__} M={x.shape[0]} K={x.shape[1]} N={w.shape[1]}", out,
                  plain(x, w, *args))
            keep(key, x, w, *args)
            return out
        return mm

    def w8a8_mm(x, w, scale, act_scale=None):
        key = ("w8a8_matmul", *x.shape, w.shape[1], act_scale is not None)
        out = launch(qm.w8a8_matmul, key, lambda: qm.w8a8_matmul(x, w, scale, act_scale))
        checks.differ(f"w8a8_matmul M={x.shape[0]} K={x.shape[1]} N={w.shape[1]}: differs "
                      "from its plain version", ((out, qm.w8a8_matmul_ref(x, w, scale,
                                                                          act_scale)),))
        held["w8a8_matmul"] = held.get("w8a8_matmul", 0) + 1
        keep(key, x, w, scale, act_scale)
        return out

    def updating(kernel, plain, n_bufs):
        def update(q, k_new, v_new, *rest, start=None):
            bufs, pos = rest[:n_bufs], rest[n_bufs]
            refs = [t.clone() for t in bufs]
            key = (kernel.__name__, str(q.dtype), q.shape[0], bufs[0].shape[1],
                   start is not None)
            out = launch(kernel, key, lambda: kernel(q, k_new, v_new, *bufs, pos, start=start))
            ref = plain(q, k_new, v_new, *refs, pos, start)
            what = f"{kernel.__name__} ({q.shape[0]} rows, {q.dtype}) pos {pos}"
            checks.differ(f"{what}: cache rows or scales differ", zip(bufs, refs))
            close(what, out, ref)
            keep(key, q, k_new, v_new, *refs, pos, start)
            return out
        return update

    def preprocess(wav, n_mels=80, length=480_000, dft_dtype=torch.float32):
        # the frontend, whose `log_mel_cuda` call runs the kernel (its launch
        # counter lives on `mel_kernel.log_mel_cuda`, which stays in place)
        out = launch(wrappers[-1], ("log_mel_cuda", wav.shape[0]),
                     lambda: real_pre(wav, n_mels, length, dft_dtype))
        w = features.pad_or_trim(wav, length)
        exact = features.log_mel_f64(w, n_mels, dft_dtype)
        err_k, err_p = (float((x.double() - exact).abs().max()) for x in
                        (out, features.log_mel(w, n_mels, dft_dtype)))
        check(err_k <= err_p + MEL_EXACT_MARGIN, f"log_mel_cuda {tuple(w.shape)}: the "
              f"kernel is {err_k} from the float64 log-mel, the plain version {err_p}")
        held["log_mel_cuda"] = held.get("log_mel_cuda", 0) + 1
        return out

    def card_only(mod, name, shim):
        # calls on CPU tensors (a CPU f32 recompute on another thread) pass
        # through: they launch no kernel
        real = getattr(mod, name)

        def fn(x, *a, **kw):
            return (shim if x.is_cuda else real)(x, *a, **kw)
        return (mod, name, fn)

    real_pre = features.preprocess
    patches = [(features, "preprocess", preprocess)] if mel else []
    patches += [(whisper, "encoder_attention", enc_attn),
               (whisper, "transpose_quant_kv", tq),
               (whisper, "decode_cross_attention_grouped", grouped),
               (whisper, "decode_cross_attention", one_query),
               (lin, "int8_matmul", weight_only(qm.int8_matmul, qm.int8_matmul_ref)),
               (lin, "int4_matmul", weight_only(qm.int4_matmul, qm.int4_matmul_ref)),
               (lin, "nf4_matmul", weight_only(qm.nf4_matmul, qm.nf4_matmul_ref)),
               (lin, "w8a8_matmul", w8a8_mm),
               (decode, "decode_self_attention_update",
                updating(sas.decode_self_attention_update,
                         sas.decode_self_attention_update_ref, 2)),
               (decode, "decode_self_attention_update_int8",
                updating(sas.decode_self_attention_update_int8,
                         sas.decode_self_attention_update_int8_ref, 4))]
    _HELD_BLOCKS.append(ledger)
    try:
        with patched(*(card_only(*p) for p in patches)):
            yield held
        checks.verify()
        launched_ = ledger.check()
    finally:
        _HELD_BLOCKS.remove(ledger)
    log(f"held block: {sum(launched_.values())} launches, each inside a shim "
        f"{json.dumps(launched_)}")


def held_summary(held: dict, shapes: dict) -> str:
    """One log line's account of what `checked_kernel_calls` held."""
    return (f"kernel calls held against their plain versions {json.dumps(held)} at "
            f"shapes {sorted(map(str, shapes))}")


def check_enc_attn_shape(what: str, q, k, v, timed: bool = True) -> dict:
    """The encoder attention at a recorded shape, in q's type, against its
    plain version (within KERNEL_REL of its largest output), one launch
    counted in the type's counter, timed beside it, `sdpa` in the same type
    and its bound (the operations at the peak rate of the type: the tensor
    cores' for bf16 and f16, three TF32 products a product at 495 TFLOP/s for
    f32, `enc_attn_op_seconds`; as phase 1 at T = 1500; not `timed`: held
    only)."""
    from openai_whisper_compression_tpu_torch.ops.attention import (
        encoder_attention, encoder_attention_ref)

    b, h, t, dh = q.shape
    attr = "launches" + _SUFFIX[q.dtype]
    before = getattr(encoder_attention, attr)
    got, ref = encoder_attention(q, k, v), encoder_attention_ref(q, k, v)
    check(getattr(encoder_attention, attr) == before + 1, f"{what}: no launch counted")
    err, tol = max_err(got, ref), KERNEL_REL[q.dtype] * float(ref.float().abs().max())
    check(got.dtype == q.dtype and bool(torch.isfinite(got).all()) and err <= tol,
          f"{what}: err {err} > {tol}, or not finite, or of type {got.dtype}")
    del ref
    if not timed:
        return held_only("", what, (b, h, t, dh), err, tol)
    t_k = cuda_ms(lambda: encoder_attention(q, k, v))
    t_p = cuda_ms(lambda: encoder_attention_ref(q, k, v), warmup=1, iters=3)
    t_lib = cuda_ms(lambda: sdpa(q, k, v))
    least = bound(4 * b * h * t * dh * q.element_size(),
                  enc_attn_op_seconds(4 * b * h * t * t * dh, q.dtype))
    log(f"{what} ({b}, {h}, {t}, {dh}) {q.dtype}: err {err:.3g} (bound {tol:.3g}) "
        f"kernel {t_k:.4f} ms plain {t_p:.4f} ms sdpa {t_lib:.4f} ms least "
        f"{least['bound_ms']:.4f} ms ({least['bound_by']})")
    return {"max_abs_err": err, "ms": t_k, "plain_ms": t_p, **least, "library_ms": t_lib}


@torch.inference_mode()
def run_merge_pool(dev, arch, params, results: dict) -> dict:
    """Token merging at batch 32 (MERGE_RUNS): the encoder's `merge_at=6`
    (the last six layers at T = 750), `cross_kv_pool=2` with int8 cross-KV
    (S = 750) and `cross_kv_merge=300` with bf16 cross-KV (S = 1200). Every
    call of the encoder attention, the cross-KV quantizer and the
    cross-attentions is held against its plain version as the model makes
    it (`checked_kernel_calls`, the int8 matmul and the cache update too);
    each new shape is then timed beside its plain version and bound. Exact
    launch counts per configuration; the first rows' tokens against the f32
    path on the card through the plain versions under the tie rule."""
    from openai_whisper_compression_tpu_torch.config import DecodeConfig
    from openai_whisper_compression_tpu_torch.evaluation.harness import make_transcribe_fn
    from openai_whisper_compression_tpu_torch.models import decode
    from openai_whisper_compression_tpu_torch.models.params import tree_to

    b, n_ref = BATCH, 1
    wav = torch.from_numpy(waveforms(SEED + 7, b)).to(dev)
    params32 = tree_to(params, dev, torch.float32)
    summaries = {}
    for name, fn_kw, switches, path in MERGE_RUNS:
        cfg = DecodeConfig(max_new_tokens=NEW_TOKENS, suppress_tokens=(arch.eos_token_id,),
                           **switches)
        log(f"phase4 {name}: {arch.name}, int8 weights, batch {b}, {json.dumps(fn_kw)} "
            f"{json.dumps(switches)}")
        fn = make_transcribe_fn(arch, cfg, fast_mel=True, fast_gelu=True, device=dev, **fn_kw)
        shapes: dict = {}
        with checked_kernel_calls(shapes) as held:
            counters = zero_launches()
            t0 = time.perf_counter()
            tokens, lengths = (x.cpu() for x in fn(params, wav))
            wall = time.perf_counter() - t0
            launches = read_launches(counters)
        log(f"phase4 {name} launches {json.dumps(launches)}; {held_summary(held, shapes)}")
        exact = expected_launches(arch, path, [NEW_TOKENS])
        exact["log_mel_cuda"] = 1
        check_launches(name, launches, ("int8_matmul",) + path, exact)
        check(bool((lengths == 4 + NEW_TOKENS).all()) and int(tokens.max()) < arch.vocab_size,
              f"{name}: lengths {lengths.tolist()}")
        log(f"phase4 {name}: wall {wall:.4f} s (every kernel call checked)")

        # the first rows against the f32 path on the card through the plain
        # versions (no kernel launches), tie rule
        t1 = time.perf_counter()
        counters = zero_launches()
        with plain_kernels(), torch.inference_mode():
            enc = cpu_enc(params32, arch, wav[:n_ref], device=dev, **fn_kw)
            ref, _ = decode.greedy_decode(params32, arch, enc, cfg)
            parted = check_ties(name, params32, arch, cfg, wav[:n_ref], tokens[:n_ref],
                                ref.cpu(), 4, fn_kw, device=dev)
        ref_launches = read_launches(counters)
        check(not any(ref_launches.values()),
              f"{name}: the f32 recompute launched {launched(ref_launches)}")
        log(f"phase4 {name}: the first {n_ref} row(s) against the f32 path on the card "
            f"through the plain versions: {n_ref - parted} equal, {parted} part at a "
            f"proven tie ({time.perf_counter() - t1:.1f} s, no kernel launched)")
        # the new shapes this run reports, timed
        for _, _, run, key, rkey in SHAPE_ENTRIES:
            if run != name:
                continue
            check(key in shapes, f"{name}: the model never called the {key} shape")
            if key[0] == "encoder_attention":
                results[rkey] = check_enc_attn_shape(f"phase4 {name} encoder_attention",
                                                     *shapes[key])
            elif key[0] == "transpose_quant_kv":
                results[rkey] = check_tq(*shapes[key], phase="phase4")[0]
            else:
                results[rkey] = check_grouped(f"{name} grouped {key[1]}", *shapes[key],
                                              phase="phase4")
        summaries[name] = {"batch": b, "walls_s": [wall], "launches": launches}
    return summaries


def run_fallback(dev, arch, params) -> dict:
    """`decode_with_fallback` at batch 32 with fp (bf16) caches, the default
    ladder and best_of=2, drawing from a seeded `torch.Generator` on the
    card. On seeded weights every row fails OpenAI's gates at every rung, so
    the gates are set from a first greedy decode of the same audio: the
    logprob gate at the median of its rows' mean logprobs (over the rows
    that pass the compression gate; the compression gate is dropped where
    fewer than two do), and rows part at t = 0 and at later rungs. Checks:
    the t = 0 rung equals `greedy_decode` bit for bit, two calls with one
    seed give the same result, every row keeps the rung at which it first
    passed the gates (or the last), rows are kept at t = 0 and at a later
    rung, the attention kernels launch exactly as the rungs' steps ask, and
    every kernel call is held against its plain version
    (`checked_kernel_calls`)."""
    from openai_whisper_compression_tpu_torch.audio.features import preprocess
    from openai_whisper_compression_tpu_torch.config import DecodeConfig
    from openai_whisper_compression_tpu_torch.evaluation.tokenizer import (
        default_tokenizer)
    from openai_whisper_compression_tpu_torch.models import decode, fallback
    from openai_whisper_compression_tpu_torch.models.whisper import encode

    name, b, best_of, seed = "fallback", BATCH, 2, SEED + 11
    cfg = DecodeConfig(max_new_tokens=NEW_TOKENS)
    tok = default_tokenizer(arch)
    p_len = len(decode.forced_prefix(arch, cfg))
    eot = arch.eos_token_id

    def text(toks, lens, i):
        return tok.decode([int(x) for x in toks[i, p_len: lens[i]] if x != eot])

    def encoded(wav):
        mel = preprocess(wav, arch.num_mel_bins, dft_dtype=torch.bfloat16)
        return encode(params, arch, mel.to(torch.bfloat16), fast_gelu=True)

    rungs = []
    real_greedy = fallback.greedy_decode

    def recorded(*a, **kw):
        out = real_greedy(*a, **kw)
        rungs.append((kw["temperature"], *(x.cpu() for x in out)))
        return out

    shapes: dict = {}
    fallback.greedy_decode = recorded
    try:
        with torch.inference_mode(), checked_kernel_calls(shapes) as held:
            wav = torch.from_numpy(waveforms(SEED + 3, b)).to(dev)
            # the gates, from a first greedy decode of the same audio
            toks, lens, lps = (x.cpu().numpy() for x in decode.greedy_decode(
                params, arch, encoded(wav), cfg, return_logprobs=True))
            ratios = np.array([fallback.compression_ratio(text(toks, lens, i))
                               for i in range(b)])
            passing = ratios <= 2.4
            ratio_gate = 2.4 if passing.sum() >= 2 else None
            lp_gate = float(np.median(lps[passing] if ratio_gate else lps))
            gates = {"compression_ratio_threshold": ratio_gate,
                     "logprob_threshold": lp_gate}
            log(f"phase4 {name}: {arch.name}, int8 weights, batch {b}, bf16 caches, "
                f"ladder {fallback.DEFAULT_TEMPERATURES}, best_of {best_of}, seed "
                f"{seed}; gates {json.dumps(gates)} (greedy: {int(passing.sum())} of "
                f"{b} rows pass the compression gate at 2.4, mean logprobs "
                f"{lps.min():.4f}..{lps.max():.4f})")
            counters = zero_launches()
            t0 = time.perf_counter()
            enc = encoded(wav)
            res = fallback.decode_with_fallback(params, arch, enc, tok.decode, cfg=cfg,
                                                seed=seed, best_of=best_of, **gates)
            wall = time.perf_counter() - t0
            launches = read_launches(counters)
            first = list(rungs)
            again = fallback.decode_with_fallback(params, arch, enc, tok.decode, cfg=cfg,
                                                  seed=seed, best_of=best_of, **gates)
            greedy, g_len, g_lp = decode.greedy_decode(params, arch, enc, cfg,
                                                       return_logprobs=True)
    finally:
        fallback.greedy_decode = real_greedy
    log(f"phase4 {name} launches {json.dumps(launches)}; {held_summary(held, shapes)}")
    temps = [t for t, *_ in first]
    steps = [int(lens.max()) - p_len for _, _, lens, _ in first]
    path = ("log_mel_cuda", "encoder_attention", "int8_matmul",
            "decode_cross_attention_grouped", "decode_self_attention_update")
    exact = expected_launches(arch, path, steps)
    exact.update({"log_mel_cuda": 1, "encoder_attention": arch.encoder_layers})
    check_launches(name, launches, path, exact)
    check(temps[0] == 0.0 and torch.equal(first[0][1], greedy.cpu())
          and torch.equal(first[0][2], g_len.cpu()) and torch.equal(first[0][3], g_lp.cpu()),
          f"{name}: the t = 0 rung differs from greedy_decode")
    for f in ("tokens", "lengths", "avg_logprobs", "temperatures", "texts"):
        check(np.array_equal(np.asarray(getattr(res, f)), np.asarray(getattr(again, f))),
              f"{name}: two calls with seed {seed} differ in {f}")
    # the ladder replayed from the recorded rungs: each row keeps the rung at
    # which it passed both gates, or the last one
    pending = np.ones(b, bool)
    want = {}
    for t, toks, lens, lps in first:
        n_cand = best_of if t > 0 else 1
        check(toks.shape[0] == b * n_cand, f"{name}: rung {t} decoded {toks.shape[0]} rows")
        sel = np.arange(b) * n_cand + lps.numpy().reshape(b, n_cand).argmax(axis=1)
        toks, lens, lps = toks.numpy()[sel], lens.numpy()[sel], lps.numpy()[sel]
        fails = np.zeros(b, bool)
        for i in np.flatnonzero(pending):
            want[i] = (t, toks[i], lens[i], lps[i])
            fails[i] = fallback.needs_fallback(
                float(lps[i]), fallback.compression_ratio(text(toks, lens, i)),
                ratio_gate, lp_gate)
        pending &= fails
    check(not pending.any() or len(first) == len(fallback.DEFAULT_TEMPERATURES),
          f"{name}: the ladder stopped with rows still failing")
    for i, (t, toks, lens, lps) in want.items():
        check(res.temperatures[i] == t and np.array_equal(res.tokens[i], toks)
              and res.lengths[i] == lens and res.avg_logprobs[i] == lps,
              f"{name}: row {i} kept another rung's result than the gates give")
    counts = {t: int((res.temperatures == t).sum()) for t in temps}
    check(counts[0.0] > 0 and counts[0.0] < b,
          f"{name}: rows kept per rung {counts}: the gates do not part the rows")
    log(f"phase4 {name}: {len(temps)} rungs (steps {steps}), rows kept per rung "
        f"{counts}, mean logprob {float(res.avg_logprobs.mean()):.4f}; the t = 0 rung "
        f"equals greedy_decode bit for bit; two calls with one seed equal; every row "
        f"kept at the rung the gates give; wall {wall:.2f} s (every kernel call "
        "checked)")
    return {"batch": b, "walls_s": [wall], "launches": launches}


# ---------------------------------------------------------------------------
# Phase 5 (slice 12): long-form seek, word timestamps, speculative decoding
# ---------------------------------------------------------------------------

SEEK_STREAMS = 32    # bench.py's longform row: 32 streams of 45-75 s
SPEC_GAMMA = 4
TS_KV8 = {"notimestamps": False, **KV8}
# - the alignment pass (`cross_attention_weights`) on the card in bf16 against
#   the same tree and encoder states in f32 on the CPU: softmax rows at the
#   end of the teacher-forced decoder, held to phase 3's logits budget
ALIGN_REL_L2 = LOGITS_REL_L2
# kernels-line entries for the shapes phase 5 gives the kernels: (entry name,
# the KERNELS entry, the run whose calls at that shape it counts and times, the
# shape key of `checked_kernel_calls`; None: the run's first int8-matmul shape
# with M = the alignment's tokens)
P5_ENTRIES = [
    ("int8_matmul@tiny-qkv-M32", "int8_matmul", "spec-tiny", ("int8_matmul", 32, 384, 1152)),
    ("int8_matmul@tiny-fc2-M32", "int8_matmul", "spec-tiny", ("int8_matmul", 32, 1536, 384)),
    ("encoder_attention@tiny", "encoder_attention", "spec-tiny", ("encoder_attention", 6, 1500)),
    ("transpose_quant_kv@tiny", "transpose_quant_kv", "spec-tiny",
     ("transpose_quant_kv", 1500, 384)),
    ("decode_cross_attention_grouped_int8@tiny-192rows", "decode_cross_attention_grouped_int8",
     "spec-tiny", ("grouped", "torch.int8", 1500, 1, 192)),
    # the draft's cache: greedy's 64 rows + gamma + 1 of workspace
    ("decode_self_attention_update_int8@tiny-ws69", "decode_self_attention_update_int8",
     "spec-tiny", ("decode_self_attention_update_int8", "torch.bfloat16", 192,
                   64 + SPEC_GAMMA + 1, False)),
    ("int8_matmul@verify-M160", "int8_matmul", "spec-tiny", ("int8_matmul", 160, 768, 2304)),
    ("decode_cross_attention_grouped_int8_wide@verify-5slots",
     "decode_cross_attention_grouped_int8_wide", "spec-tiny",
     ("grouped", "torch.int8", 1500, 5, 384)),
    # the verify window of 44 positions: one call, 5 launches of 8 slots
    # and one of 4 (the narrow entry's)
    ("decode_cross_attention_grouped_int8_wide@verified-44slots",
     "decode_cross_attention_grouped_int8_wide", "verified-greedy-draft",
     ("grouped", "torch.int8", 1500, 44, 384)),
    ("int8_matmul@align", "int8_matmul", "seek-words", None),
]


def phase5_waves(seed: int, lo_s: float, hi_s: float, n: int) -> tuple:
    """bench.py's longform streams: n lengths uniform in [lo_s, hi_s] s, then
    each stream's `standard_normal * 0.1` samples, from one generator."""
    rng = np.random.default_rng(seed)
    lens_s = rng.uniform(lo_s, hi_s, n)
    return lens_s, [rng.standard_normal(int(s * 16000)).astype(np.float32) * 0.1
                    for s in lens_s]


def check_ts_rows(name: str, arch, cfg, gens) -> int:
    """The timestamp rules on generated rows (each cut at its first EOT): an
    early timestamp first, no <|notimestamps|>, timestamps that never
    decrease, never three in a row. Returns the timestamps seen."""
    ts_begin, seen = arch.no_timestamps_token_id + 1, 0
    for row in gens:
        row = [int(t) for t in row]
        if arch.eos_token_id in row:
            row = row[: row.index(arch.eos_token_id)]
        if not row:
            continue
        check(ts_begin <= row[0] <= ts_begin + cfg.max_initial_timestamp_index,
              f"{name}: first token {row[0]} is not an early timestamp")
        check(arch.no_timestamps_token_id not in row, f"{name}: <|notimestamps|> sampled")
        stamps = [t for t in row if t >= ts_begin]
        check(stamps == sorted(stamps), f"{name}: timestamps decrease: {stamps}")
        runs = "".join("t" if t >= ts_begin else "w" for t in row)
        check("ttt" not in runs, f"{name}: three timestamps in a row: {runs}")
        seen += len(stamps)
    return seen


def decode_launches(arch, steps: list, rows_per_call: list | None = None,
                    extra_int8: int = 0) -> dict:
    """Exact launch counts of `make_transcribe_fn` calls on whisper-small's
    path with int8 weights, int8 self-KV and cross-KV (bf16 tree), one call
    per entry of `steps` (its decoder steps): the mel, the encoder attention
    a layer, the cross-KV quantizer for K and V a layer, the int8 matmul for
    the prefill's and each step's 6 linears a layer (plus `extra_int8`), the
    grouped cross-attention for the prefill window and, at B·H % 16 = 0, for
    each step (else the one-query kernel: `rows_per_call` the batch of each
    call), the int8 cache update a layer and step."""
    layers, n = arch.decoder_layers, len(steps)
    rows_per_call = rows_per_call or [BATCH] * n
    grouped = sum(1 + (s if b * arch.decoder_heads % 16 == 0 else 0)
                  for s, b in zip(steps, rows_per_call))
    one_query = sum(s for s, b in zip(steps, rows_per_call)
                    if b * arch.decoder_heads % 16 != 0)
    return {"log_mel_cuda": n, "encoder_attention": arch.encoder_layers * n,
            "transpose_quant_kv": 2 * layers * n,
            "int8_matmul": 6 * layers * (n + sum(steps)) + extra_int8,
            "decode_cross_attention_grouped_int8": layers * grouped,
            "decode_cross_attention_int8": layers * one_query,
            "decode_self_attention_update_int8": layers * sum(steps)}


def results_equal(a, b) -> bool:
    """Result dicts (lists of them) equal, key for key."""
    return json.dumps(a, sort_keys=True, default=str) == json.dumps(b, sort_keys=True,
                                                                      default=str)


def record_decodes(longform, sink: list):
    """A patch of `longform.make_transcribe_fn` whose functions record each
    call's window batch, tokens and lengths into `sink`."""
    real_make = longform.make_transcribe_fn

    def make(*a, **kw):
        fn = real_make(*a, **kw)

        def recorded(p, wav):
            res = fn(p, wav)
            sink.append((wav.clone(), res[0].cpu(), res[1].cpu()))
            return res
        return recorded

    return (longform, "make_transcribe_fn", make)


def run_seek_small(dev, arch, params) -> tuple:
    """`transcribe_seek_batch(batch_size=32, stage_int16=True)` over bench.py's
    longform streams with crafted timestamp embeddings, int8 caches, 25
    tokens: a cold and a steady call, timed (launch counts exact), then a
    third with every kernel call held against its plain version, every
    window batch cut on the card checked bit for bit against the host's
    slice of the int16 pool (idle rows zero), every window's tokens against
    a direct `make_transcribe_fn` call on that batch, the timestamp rules,
    segments in order, each inside the window that decoded it, every window
    starting inside its stream, window counts that differ.
    Returns the summary and the crafted tree."""
    from openai_whisper_compression_tpu_torch.audio.features import preprocess
    from openai_whisper_compression_tpu_torch.config import DecodeConfig
    from openai_whisper_compression_tpu_torch.evaluation import longform
    from openai_whisper_compression_tpu_torch.evaluation.harness import samples_for_arch
    from openai_whisper_compression_tpu_torch.evaluation.tokenizer import default_tokenizer
    from openai_whisper_compression_tpu_torch.models.decode import forced_prefix

    name, b = "seek-small", SEEK_STREAMS
    cfg = DecodeConfig(max_new_tokens=NEW_TOKENS, **TS_KV8)
    n = samples_for_arch(arch)
    lens_s, wavs = phase5_waves(3, 45.0, 75.0, b)
    probe = np.stack([np.pad(w[:n], (0, max(0, n - len(w)))) for w in wavs[:8]])
    lf = craft_ts_embeddings(params, arch, preprocess(torch.from_numpy(probe).to(dev),
                                                      arch.num_mel_bins, length=n))
    tok = default_tokenizer(arch)
    fg = len(forced_prefix(arch, cfg))
    log(f"phase5 {name}: {arch.name}, int8 weights, int8 self-KV and cross-KV, "
        f"timestamps, crafted timestamp embeddings, {b} streams of "
        f"{lens_s.min():.1f}-{lens_s.max():.1f} s ({lens_s.sum():.1f} s), batch {b}, "
        "int16 staging")

    def run():
        return longform.transcribe_seek_batch(lf, arch, wavs, tok, cfg, batch_size=b,
                                              stage_int16=True, device=dev)

    walls, outs = [], []
    for what in ("cold", "steady"):
        counters = zero_launches()
        t0 = time.perf_counter()
        outs.append(run())
        walls.append(time.perf_counter() - t0)
        outs.append(read_launches(counters))
        log(f"phase5 {name} {what}: wall {walls[-1]:.4f} s")
    check(results_equal(outs[0], outs[2]), f"{name}: the steady call differs from the cold")

    cuts, decodes = [], []
    real_cut, real_make = longform._cut_windows, longform.make_transcribe_fn

    def cut(pool, starts, batch_size, n_samples):
        out = real_cut(pool, starts, batch_size, n_samples)
        cuts.append((list(starts), out.clone()))
        return out

    shapes: dict = {}
    with patched((longform, "_cut_windows", cut), record_decodes(longform, decodes)), \
            checked_kernel_calls(shapes) as held:
        counters = zero_launches()
        t0 = time.perf_counter()
        res = run()
        held_wall = time.perf_counter() - t0
        launches = read_launches(counters)
    log(f"phase5 {name} held: wall {held_wall:.2f} s; {held_summary(held, shapes)}")
    check(results_equal(res, outs[0]), f"{name}: the held call differs from the timed ones")
    steps = [int(lens.max()) - fg for _, _, lens in decodes]
    exact = decode_launches(arch, steps)
    for launched in (outs[1], outs[3], launches):
        check_launches(name, launched, tuple(exact), exact)
    log(f"phase5 {name} launches {json.dumps(launches)} (each call; steps {steps})")

    # the window batches against the host's int16 pool, and against a direct call
    pool = np.zeros((b, max(len(w) for w in wavs) + n), np.int16)
    for i, w in enumerate(wavs):
        pool[i, : len(w)] = np.clip(w * 32767.0, -32768, 32767).astype(np.int16)
    direct = real_make(arch, cfg, token_logprobs=True, device=dev)
    check(len(cuts) == len(decodes), f"{name}: {len(cuts)} cuts for {len(decodes)} decodes")
    for (starts, got), (wav, tokens, lengths) in zip(cuts, decodes):
        want = np.zeros((b, n), np.float32)
        for r, (si, o) in enumerate(starts):
            want[r] = pool[si, o: o + n].astype(np.float32) * np.float32(1.0 / 32767.0)
        check(np.array_equal(got.cpu().numpy(), want) and torch.equal(got, wav),
              f"{name}: a window batch cut on the card differs from the host's slice")
        t2, l2 = (x.cpu() for x in direct(lf, wav)[:2])
        check(torch.equal(t2, tokens) and torch.equal(l2, lengths),
              f"{name}: a window's tokens differ from a direct call on its batch")
        check_ts_rows(name, arch, cfg, [tokens[r, fg: lengths[r]] for r in range(len(starts))])
    idle = sum(b - len(st) for st, _ in cuts)

    # segments in order, each inside the window that decoded it, every window
    # starting inside its stream (a window's tail past the stream's end is
    # padding, into which a seeded model may still place timestamps)
    offsets = [[] for _ in range(b)]
    for starts, _ in cuts:
        for si, o in starts:
            offsets[si].append(o / 16000.0)
    past_end = 0
    for si, r in enumerate(res):
        st = [x["start"] for x in r["segments"]]
        check(st == sorted(st) and all(t0 < lens_s[si] for t0 in offsets[si]),
              f"{name}: stream {si} segment starts {st[:8]} out of order")
        for x in r["segments"]:
            check(any(t0 <= x["start"] and (x["end"] is None or x["start"] <= x["end"]
                                            <= t0 + AUDIO_S) for t0 in offsets[si]),
                  f"{name}: stream {si} segment {x['start']}-{x['end']} lies in no window")
            past_end += x["start"] >= lens_s[si]
    counts = [r["num_windows"] for r in res]
    check(len(set(counts)) > 1, f"{name}: every stream took {counts[0]} windows")
    windows, segments = sum(counts), sum(len(r["segments"]) for r in res)
    wall = walls[1]
    summary = {"rtfx": float(lens_s.sum()) / wall, "window_rtfx": windows * AUDIO_S / wall,
               "windows": windows, "segments": segments,
               "mean_advance_s": float(np.mean(lens_s / np.asarray(counts))),
               "cold_wall_s": walls[0], "wall_s": wall, "iterations": len(steps),
               "launches": launches}
    log(f"phase5 {name}: {len(cuts)} window batches cut on the card equal to the host's "
        f"int16 slices ({idle} idle rows, all zero), each window's tokens equal to a "
        f"direct call's, the timestamp rules hold, segments in order inside their "
        f"windows ({past_end} of them in a last window's padding past the stream's "
        f"end); windows per stream {sorted(set(counts))}; rtfx "
        f"{summary['rtfx']:.2f} (audio s / steady wall), window_rtfx "
        f"{summary['window_rtfx']:.2f}, {windows} windows, {segments} segments, mean "
        f"advance {summary['mean_advance_s']:.2f} s, cold {walls[0]:.4f} s, steady "
        f"{wall:.4f} s")
    return summary, lf


class SpacedTokenizer:
    """`WordTokenizer`'s words with each piece led by a space, as a BPE
    vocabulary's word-initial pieces are: every text token then starts a
    word of `word_timestamps`."""

    def __init__(self, arch):
        from openai_whisper_compression_tpu_torch.evaluation.tokenizer import (
            default_tokenizer)

        self.words = default_tokenizer(arch)
        self.special_start = self.words.special_start

    def decode(self, ids) -> str:
        return "".join(" " + self.words.decode([int(i)]) for i in ids
                       if self.words.decode([int(i)]))


def words_ok(name: str, tok, arch, windows: list) -> int:
    """Per decoded window (t0 s, samples, tokens, words, the window's
    segments): the words' text joins to the window's text tokens, and the
    window's segments' text is where it starts; word times do not decrease,
    start <= end, and lie inside the window's aligned frames. Returns the
    words seen."""
    ts_begin = arch.no_timestamps_token_id + 1
    special = min(arch.eos_token_id, arch.decoder_start_token_id, ts_begin)
    seen = 0
    for t0, piece, toks, words, segs in windows:
        text = "".join(tok.decode([int(t)]).strip() for t in toks if int(t) < special)
        joined = "".join(w["word"] for w in words)
        seg_text = "".join(tok.decode(s["tokens"]).replace(" ", "") for s in segs)
        check(joined == text and text.startswith(seg_text),
              f"{name}: window at {t0:.2f} s: words {joined[:40]!r} do not join to "
              f"its text {text[:40]!r} (segments {seg_text[:40]!r})")
        starts = [w["start"] for w in words]
        check(starts == sorted(starts), f"{name}: window at {t0:.2f} s: word starts "
              f"{starts[:8]} decrease")
        # the alignment's frames: the window's samples // 320, at least one
        end = t0 + max(1, min(arch.max_source_positions, piece // 320)) * 0.02
        check(all(t0 - 1e-5 <= w["start"] <= w["end"] <= end + 1e-5 for w in words),
              f"{name}: window at {t0:.2f} s ({piece} samples): words "
              f"{[(w['start'], w['end']) for w in words][:4]} outside it")
        seen += len(words)
    return seen


def record_windows(longform, sink: list):
    """Patches that record each window's segments (`segments_from_tokens`)
    and words (`_align_window_words`) into `sink` as (t0, samples, tokens,
    words, segments, the encoder row), in call order (the seek functions
    parse a window's segments, then align it)."""
    real_seg, real_align = longform.segments_from_tokens, longform._align_window_words
    pending: list = []

    def seg(arch, gen):
        out = real_seg(arch, gen)
        pending.append(out[0])
        return out

    def align(params, arch, enc_row, win_toks, tok, heads, piece_len, t0, **kw):
        words = real_align(params, arch, enc_row, win_toks, tok, heads, piece_len, t0, **kw)
        sink.append((t0, piece_len, np.asarray(win_toks).tolist(), words, pending.pop(0),
                     enc_row))
        return words

    return ((longform, "segments_from_tokens", seg), (longform, "_align_window_words", align))


def run_seek_words(dev, arch, lf, results: dict) -> dict:
    """Word timestamps on the crafted tree: `transcribe_seek` over one 60-90
    s stream with `word_timestamps` and `hallucination_silence_threshold`,
    then `transcribe_seek_batch(word_timestamps=True)` over 4 streams at
    batch 4, every kernel call held against its plain version, exact launch
    counts (per window: the decode, the no-speech step and the alignment
    pass, whose 72 linears run the int8 matmul at M = the window's tokens).
    The alignment pass of the first window on the card within ALIGN_REL_L2
    of the CPU's f32 pass on the same tree, tokens and encoder states; the
    words well formed (`words_ok`)."""
    from openai_whisper_compression_tpu_torch.config import DecodeConfig
    from openai_whisper_compression_tpu_torch.evaluation import longform
    from openai_whisper_compression_tpu_torch.models.alignment import cross_attention_weights
    from openai_whisper_compression_tpu_torch.models.decode import forced_prefix
    from openai_whisper_compression_tpu_torch.models.params import tree_to

    name = "seek-words"
    cfg = DecodeConfig(max_new_tokens=NEW_TOKENS, **TS_KV8)
    tok = SpacedTokenizer(arch)    # one word a text token
    fg = len(forced_prefix(arch, cfg))
    lens_s, wavs = phase5_waves(4, 60.0, 90.0, 5)
    layers = arch.decoder_layers
    summary = {}
    for what, call, batch in (
            ("single", lambda: [longform.transcribe_seek(
                lf, arch, wavs[0], tok, cfg, word_timestamps=True,
                hallucination_silence_threshold=2.0, device=dev)], 1),
            ("batch", lambda: longform.transcribe_seek_batch(
                lf, arch, wavs[1:], tok, cfg, batch_size=4, word_timestamps=True,
                device=dev), 4)):
        windows, decodes = [], []
        shapes, calls = {}, {}
        with patched(*record_windows(longform, windows), record_decodes(longform, decodes)), \
                checked_kernel_calls(shapes, calls) as held:
            counters = zero_launches()
            t0 = time.perf_counter()
            res = call()
            wall = time.perf_counter() - t0
            launches = read_launches(counters)
        log(f"phase5 {name} {what}: wall {wall:.2f} s (every kernel call checked); "
            f"{held_summary(held, shapes)}")
        steps = [int(lens.max()) - fg for _, _, lens in decodes]
        exact = decode_launches(arch, steps, [batch] * len(steps),
                                extra_int8=6 * layers * (len(steps) + len(windows)))
        check_launches(f"{name} {what}", launches, tuple(exact), exact)
        n_words = words_ok(f"{name} {what}", tok, arch, [w[:5] for w in windows])
        for s, r in enumerate(res):
            a_s = lens_s[s + (batch > 1)]
            check(all(0.0 <= w["start"] <= w["end"] <= a_s + AUDIO_S for w in r["words"]),
                  f"{name} {what}: stream {s} has words outside it")
        log(f"phase5 {name} {what}: {len(windows)} windows, {n_words} words (times in "
            f"order inside their windows, start <= end, joined to the windows' text), "
            f"{sum(len(r['segments']) for r in res)} segments; launches "
            f"{json.dumps(launches)}")
        summary[what] = {"wall_s": wall, "windows": len(windows), "words": n_words}
        if what == "single":
            first = windows[0]
            summary.update(launches=launches, align_tokens=len(first[2]))
            results["p5_shapes_seek-words"] = (shapes, calls)
            # the alignment pass on the card against the CPU's f32 pass
            toks = torch.tensor([first[2]], device=dev)
            card = cross_attention_weights(lf, arch, toks, first[5]).float().cpu()

            def align_cpu(lf_cpu, toks, enc_row):
                ref = cross_attention_weights(lf_cpu, arch, toks, enc_row)
                rel = float((card - ref).norm() / ref.norm())
                log(f"phase5 {name} cross_attention_weights {tuple(card.shape)} card bf16 "
                    f"vs CPU f32 on the same tree, tokens and encoder states: relative L2 "
                    f"{rel:.4g} (bound {ALIGN_REL_L2}), max abs {max_err(card, ref):.4g}")
                check(card.shape == ref.shape and bool(torch.isfinite(card).all())
                      and rel <= ALIGN_REL_L2, f"{name}: alignment pass off by {rel:.4g}")
                summary["align_rel_l2"] = rel

            later(f"phase5 {name} alignment", functools.partial(
                align_cpu, tree_to(lf, "cpu", torch.float32), toks.cpu(),
                first[5].float().cpu()))
    return summary


def run_speculative(dev, arch, params, results: dict, encs: dict) -> dict:
    """`make_speculative_transcribe_fn` at batch 32, gamma 4, 25 tokens, EOT
    suppressed, int8 caches, with a whisper-tiny draft (int8, seeded:
    spec-tiny) and with `self_speculative_draft(keep_decoder=2)` (spec-self);
    the target's greedy `make_transcribe_fn` on the same audio first. Each:
    one timed call, then one with every kernel call held against its plain
    version; exact launch counts from the rounds and draft steps the calls
    made; tokens and lengths equal to greedy's, or parted at a proven tie
    (`check_ties`). Records rounds, mean accepted drafts per round and the
    wall beside greedy's."""
    from openai_whisper_compression_tpu_torch.config import DecodeConfig
    from openai_whisper_compression_tpu_torch.evaluation.harness import (
        make_speculative_transcribe_fn, make_transcribe_fn)
    from openai_whisper_compression_tpu_torch.models import speculative
    from openai_whisper_compression_tpu_torch.models.params import tree_to

    b, gamma = BATCH, SPEC_GAMMA
    cfg = DecodeConfig(max_new_tokens=NEW_TOKENS, suppress_tokens=(arch.eos_token_id,), **KV8)
    wav = torch.from_numpy(waveforms(SEED, b)).to(dev)
    fn_g = make_transcribe_fn(arch, cfg, fast_mel=True, fast_gelu=True, device=dev)
    fn_g(params, wav)                                     # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g_tok, g_len = (x.cpu() for x in fn_g(params, wav))
    g_wall = time.perf_counter() - t0
    log(f"phase5 spec: target greedy at batch {b}: wall {g_wall:.4f} s")
    params32 = tree_to(params, dev, torch.float32)
    tiny_arch, tiny = make_params(dev, "tiny", "int8")
    summaries, walks = {}, {}   # both runs are held against g_tok: one walk a row
    for name, (arch_d, draft) in (
            ("spec-tiny", (tiny_arch, tiny)),
            ("spec-self", speculative.self_speculative_draft(params, arch, keep_decoder=2)[::-1])):
        log(f"phase5 {name}: target {arch.name}, draft {arch_d.name} "
            f"({arch_d.decoder_layers} decoder layers), int8 weights and caches, batch "
            f"{b}, gamma {gamma}, {NEW_TOKENS} tokens, EOT suppressed")
        fn = make_speculative_transcribe_fn(arch, arch_d, cfg, gamma=gamma, fast_mel=True,
                                            fast_gelu=True, device=dev)
        counts = {"draft": 0, "verify": 0}
        real_step, real_verify = speculative.decoder_step, speculative.verify_window

        def step(*a, **kw):
            counts["draft"] += 1
            return real_step(*a, **kw)

        def verify(*a, **kw):
            counts["verify"] += 1
            return real_verify(*a, **kw)

        runs = []
        for held_on in (False, True):
            shapes, calls = {}, {}
            counts.update(draft=0, verify=0)
            with patched((speculative, "decoder_step", step),
                         (speculative, "verify_window", verify)), \
                    (checked_kernel_calls(shapes, calls) if held_on
                     else contextlib.nullcontext({})) as held:
                counters = zero_launches()
                t0 = time.perf_counter()
                tokens, lengths = (x.cpu() for x in fn(params, draft, wav))
                wall = time.perf_counter() - t0
                launches = read_launches(counters)
            runs.append((tokens, lengths, wall, launches, dict(counts)))
            if held_on:
                log(f"phase5 {name} held: wall {wall:.2f} s; {held_summary(held, shapes)}")
                results[f"p5_shapes_{name}"] = (shapes, calls)
        (tokens, lengths, wall, launches, c), (t_h, l_h, _, launches_h, c_h) = runs
        check(torch.equal(tokens, t_h) and torch.equal(lengths, l_h) and c == c_h,
              f"{name}: the held call differs from the timed one")
        rounds, steps = c["verify"], c["draft"]
        lt, ld = arch.decoder_layers, arch_d.decoder_layers
        exact = {"log_mel_cuda": 2,
                 "encoder_attention": arch.encoder_layers + arch_d.encoder_layers,
                 "transpose_quant_kv": 2 * (lt + ld),
                 "int8_matmul": 6 * lt * (1 + rounds) + 6 * ld * (1 + steps),
                 "decode_cross_attention_grouped_int8": lt + ld + ld * steps,
                 "decode_cross_attention_grouped_int8_wide": lt * rounds,
                 "decode_self_attention_update_int8": ld * steps}
        for launched in (launches, launches_h):
            check_launches(name, launched, tuple(exact), exact)
        check(torch.equal(lengths, g_len), f"{name}: lengths {lengths.tolist()}")
        advanced = NEW_TOKENS              # positions the rounds moved over
        log(f"phase5 {name}: {rounds} rounds ({steps} draft steps), "
            f"{advanced / rounds - 1:.2f} drafts accepted per round on average; wall "
            f"{wall:.4f} s against greedy's {g_wall:.4f} s ({g_wall / wall:.2f}x); "
            f"launches {json.dumps(launches)}")
        summaries[name] = {"rounds": rounds, "draft_steps": steps,
                           "accepted_per_round": advanced / rounds - 1, "wall_s": wall,
                           "greedy_wall_s": g_wall, "launches": launches}
        card_ties(name, params32, arch, cfg, wav, tokens, g_tok, 4, summaries[name],
                  lambda p, name=name: f"phase5 {name}: {b - p} of {b} rows equal "
                                       f"greedy's tokens, {p} part at a proven tie",
                  encs=encs, walks=walks)
    del tiny
    return summaries


def run_verified(dev, arch, params, results: dict, encs: dict) -> dict:
    """`verified_greedy_decode` at batch 32 with a 16-token left-padded prompt
    window, timestamps on, EOT suppressed, int8 caches, two rounds, against
    `greedy_decode` with the same prompt: the draft is greedy's own tokens
    (verified-greedy-draft), junk (verified-junk: even rows random ids, odd
    rows `draft_len` 0), or greedy's tokens with the last quarter of the
    rows (8) padding lanes (`active` False, zero encoder states, no draft:
    verified-active).
    Every kernel call held against its plain version, exact launch counts
    from the sequential steps the call made (the verify windows of 44
    positions run their linears at M = 1408 through dequant + cuBLAS and the
    grouped kernel in 6 launches a layer), tokens and lengths equal to
    greedy's or parted at a proven tie, the padding lanes fully accepted and
    not holding the sequential loop open."""
    from openai_whisper_compression_tpu_torch.audio.features import preprocess
    from openai_whisper_compression_tpu_torch.config import DecodeConfig
    from openai_whisper_compression_tpu_torch.models import decode, speculative
    from openai_whisper_compression_tpu_torch.models.params import tree_to
    from openai_whisper_compression_tpu_torch.models.whisper import encode

    b, g, layers = BATCH, NEW_TOKENS, arch.decoder_layers
    cfg = DecodeConfig(max_new_tokens=g, suppress_tokens=(arch.eos_token_id,), **TS_KV8)
    wav = torch.from_numpy(waveforms(SEED, b)).to(dev)
    prompt, lens = prompt_window(arch, SEED, b)
    prompt, lens = prompt.to(dev), lens.to(dev)
    fg = PROMPT_W + len(decode.forced_prefix(arch, cfg))
    with torch.inference_mode():
        enc = encode(params, arch, preprocess(wav, arch.num_mel_bins,
                                              dft_dtype=torch.bfloat16).bfloat16(),
                     fast_gelu=True)
        g_tok, g_len = decode.greedy_decode(params, arch, enc, cfg, prompt_tokens=prompt,
                                            prompt_lens=lens)
    g_tok, g_len = g_tok.cpu(), g_len.cpu()
    check_ts_rows("verified greedy", arch, cfg, g_tok[:, fg:].tolist())
    rng = np.random.default_rng(SEED)
    exact_draft = g_tok[:, fg: fg + g].to(dev)
    junk = torch.from_numpy(rng.integers(0, 50000, (b, g))).to(dev)
    odd = torch.arange(b, device=dev) % 2 == 1
    pad = b // 4                                          # padding lanes
    active = torch.arange(b, device=dev) < b - pad
    forms = {
        "verified-greedy-draft": (enc, exact_draft, torch.full((b,), g, device=dev), None),
        "verified-junk": (enc, junk, torch.where(odd, 0, g), None),
        "verified-active": (torch.where(active[:, None, None], enc, 0), exact_draft,
                            torch.where(active, g, 0), active)}
    params32 = tree_to(params, dev, torch.float32)
    real_step = speculative.decoder_step
    window = fg + g
    chunks = [min(8, window - j0) for j0 in range(0, window, 8)]
    summaries, walks = {}, {}   # every form is held against g_tok: one walk a row
    for name, (e, draft, dlen, act) in forms.items():
        steps = [0]

        def step(*a, **kw):
            steps[0] += 1
            return real_step(*a, **kw)

        shapes, calls = {}, {}
        with patched((speculative, "decoder_step", step)), \
                checked_kernel_calls(shapes, calls) as held, torch.inference_mode():
            counters = zero_launches()
            t0 = time.perf_counter()
            tokens, lengths, n_acc = speculative.verified_greedy_decode(
                params, arch, e, cfg, draft, dlen, prompt_tokens=prompt,
                prompt_lens=lens, active=act)
            tokens, lengths, n_acc = tokens.cpu(), lengths.cpu(), n_acc.cpu()
            wall = time.perf_counter() - t0
            launches = read_launches(counters)
        results[f"p5_shapes_{name}"] = (shapes, calls)
        s = steps[0]
        exact = {"transpose_quant_kv": 2 * layers,
                 "int8_matmul": 6 * layers * s,
                 "decode_cross_attention_grouped_int8":
                     layers * (2 * sum(c <= 4 for c in chunks) + s),
                 "decode_cross_attention_grouped_int8_wide": layers * 2 * sum(c > 4 for c in chunks),
                 "decode_self_attention_update_int8_start": layers * s}
        check_launches(name, launches, tuple(exact), exact)
        rows = slice(None) if act is None else slice(0, b - pad)
        check(torch.equal(lengths[rows], g_len[rows]), f"{name}: lengths {lengths.tolist()}")
        n0 = int(n_acc[rows].min())
        check(s <= g - n0, f"{name}: {s} sequential steps after a batch-min accept of {n0}")
        if act is not None:
            check(bool((n_acc[b - pad:] == g).all()),
                  f"{name}: padding lanes report accepts {n_acc[b - pad:].tolist()}")
        check_ts_rows(name, arch, cfg, tokens[rows, fg:].tolist())
        log(f"phase5 {name}: {held_summary(held, shapes)}")
        log(f"phase5 {name}: n_acc {sorted(set(n_acc.tolist()))} (batch-min {n0}), {s} "
            f"sequential steps, wall {wall:.4f} s (every kernel call checked); launches "
            f"{json.dumps(launches)}")
        summaries[name] = {"n_acc_min": n0, "steps": s, "wall_s": wall, "launches": launches}
        n_rows = tokens[rows].shape[0]
        card_ties(name, params32, arch, cfg, wav[rows], tokens[rows], g_tok[rows], fg,
                  summaries[name],
                  lambda p, name=name, n_rows=n_rows: f"phase5 {name}: {n_rows - p} of "
                  f"{n_rows} rows equal greedy's tokens, {p} part at a proven tie",
                  prompt=prompt[rows], lens=lens[rows], encs=encs, walks=walks)
    return summaries


def run_longform_batched(dev, arch, params) -> dict:
    """`transcribe_long` at batch 8 over a 240 s stream (eight 30 s chunks,
    one call), int8 caches, 25 tokens: every kernel call held against its
    plain version, exact launch counts, chunk texts equal to the tokenizer's
    decode of `make_transcribe_fn` on the same chunks called directly."""
    from openai_whisper_compression_tpu_torch.config import DecodeConfig
    from openai_whisper_compression_tpu_torch.evaluation import longform
    from openai_whisper_compression_tpu_torch.evaluation.harness import (
        make_transcribe_fn, samples_for_arch)
    from openai_whisper_compression_tpu_torch.evaluation.tokenizer import default_tokenizer

    name, b = "longform-batched", 8
    cfg = DecodeConfig(max_new_tokens=NEW_TOKENS, **KV8)
    n = samples_for_arch(arch)
    wav = np.random.default_rng(5).standard_normal(240 * 16000).astype(np.float32) * 0.1
    tok = default_tokenizer(arch)
    fn = make_transcribe_fn(arch, cfg, device=dev)
    shapes: dict = {}
    with checked_kernel_calls(shapes) as held:
        counters = zero_launches()
        t0 = time.perf_counter()
        res = longform.transcribe_long(params, arch, wav, tok, cfg, batch_size=b,
                                       transcribe_fn=fn, device=dev)
        wall = time.perf_counter() - t0
        launches = read_launches(counters)
    buf = np.stack(longform.chunk_waveform(wav, n))
    tokens, lengths = (x.cpu() for x in fn(params, torch.from_numpy(buf)))
    texts = [tok.decode(tokens[i, : lengths[i]].tolist()) for i in range(b)]
    check(res["num_chunks"] == b and res["chunks"] == texts,
          f"{name}: chunk texts differ from the direct call's")
    steps = [int(lengths.max()) - 4]
    exact = decode_launches(arch, steps, [b])
    check_launches(name, launches, tuple(exact), exact)
    log(f"phase5 {name}: {arch.name}, int8 weights and caches, 240 s in {b} chunks, one "
        f"call: chunk texts equal the direct call's; wall {wall:.4f} s (every kernel call "
        f"checked); {held_summary(held, shapes)}; launches {json.dumps(launches)}")
    return {"batch": b, "walls_s": [wall], "launches": launches}


@torch.inference_mode()
def time_p5_shape(what: str, key: tuple, args: tuple, phase: str = "phase5") -> dict:
    """A kernel at a shape phase 5 (or `phase`) gave it, on the first call's
    inputs, against its plain version (within KERNEL_REL; caches bit for
    bit), timed beside it, its bound and the library call where there is
    one."""
    from openai_whisper_compression_tpu_torch.ops import quant_matmul as qm
    from openai_whisper_compression_tpu_torch.ops import self_attention_step as sas
    from openai_whisper_compression_tpu_torch.ops.qtensor import QTensor, dequantize

    kind = key[0]
    if kind == "encoder_attention":
        return check_enc_attn_shape(f"{phase} {what}", *args)
    if kind == "transpose_quant_kv":
        return check_tq(*args, phase=f"{phase} {what}")[0]
    if kind == "grouped":
        return check_grouped(what, *args, phase=phase)
    if kind == "int8_matmul":
        x, w, scale = args
        got, ref = qm.int8_matmul(x, w, scale), qm.int8_matmul_ref(x, w, scale)
        err, tol = max_err(got, ref), KERNEL_REL[ref.dtype] * float(ref.float().abs().max())
        check(err <= tol, f"{what}: err {err} > {tol}")
        q = QTensor(kind="int8_pc", data=w, scale=scale, shape=tuple(w.shape))
        t_k = cuda_ms(lambda: qm.int8_matmul(x, w, scale))
        t_p = cuda_ms(lambda: qm.int8_matmul_ref(x, w, scale))
        t_lib = cuda_ms(lambda: torch.matmul(x, dequantize(q, x.dtype)))
        m, k = x.shape
        least = bound(nbytes(x, w, scale, got), 2 * m * k * w.shape[1] / BF16_FLOPS)
        log(f"{phase} {what} int8_matmul M={m} K={k} N={w.shape[1]}: err {err:.3g} "
            f"(bound {tol:.3g}) kernel {t_k:.4f} ms plain {t_p:.4f} ms dequant + "
            f"torch.matmul {t_lib:.4f} ms least {least['bound_ms']:.5f} ms "
            f"({least['bound_by']})")
        return {"max_abs_err": err, "ms": t_k, "plain_ms": t_p, **least, "library_ms": t_lib}
    # the int8 cache update (over the draft's workspace cache, over
    # continuous batching's window, with the streaming prompt's start)
    q, kn, vn, kc, vc, ks, vs, pos, start = args
    refs = [t.clone() for t in (kc, vc, ks, vs)]
    got = sas.decode_self_attention_update_int8(q, kn, vn, kc, vc, ks, vs, pos, start=start)
    ref = sas.decode_self_attention_update_int8_ref(q, kn, vn, *refs, pos, start)
    err, tol = max_err(got, ref), KERNEL_REL[q.dtype] * float(ref.float().abs().max())
    check(all(torch.equal(a, r) for a, r in zip((kc, vc, ks, vs), refs)) and err <= tol,
          f"{what}: caches differ or err {err} > {tol}")
    t_k = cuda_ms(lambda: sas.decode_self_attention_update_int8(q, kn, vn, kc, vc, ks, vs,
                                                                pos, start=start))
    t_p = cuda_ms(lambda: sas.decode_self_attention_update_int8_ref(q, kn, vn, kc, vc, ks,
                                                                    vs, pos, start))
    bh, dh = q.shape
    rows = bh * (pos + 1) - (0 if start is None else int(start.sum()))   # start..pos
    least = bound(nbytes(q, kn, vn, got) + (dh + 4) * 2 * (rows + bh),
                  4 * dh * rows / BF16_FLOPS)
    log(f"{phase} {what} int8 update ({bh} rows, {kc.shape[1]}-row cache) pos={pos}"
        + ("" if start is None else f" start {int(start.min())}..{int(start.max())}")
        + f": err "
        f"{err:.3g} (bound {tol:.3g}) caches equal; kernel {t_k:.4f} ms plain {t_p:.4f} ms "
        f"least {least['bound_ms']:.5f} ms ({least['bound_by']})")
    return {"max_abs_err": err, "ms": t_k, "plain_ms": t_p, **least, "library_ms": None}


def phase5(dev, arch, params, results: dict) -> dict:
    """The slice-12 runs (module docstring), each run's seconds printed; then
    the P5_ENTRIES shapes timed. Returns the runs' summaries."""
    summaries, encs = {}, SEED_ENCS
    t0 = time.perf_counter()
    summaries["seek-small"], lf = run_seek_small(dev, arch, params)
    log(f"phase5 seek-small: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    summaries["seek-words"] = run_seek_words(dev, arch, lf, results)
    log(f"phase5 seek-words: {time.perf_counter() - t0:.1f} s")
    del lf
    t0 = time.perf_counter()
    summaries.update(run_speculative(dev, arch, params, results, encs))
    log(f"phase5 spec-tiny and spec-self: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    summaries.update(run_verified(dev, arch, params, results, encs))
    log(f"phase5 verified: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    summaries["longform-batched"] = run_longform_batched(dev, arch, params)
    log(f"phase5 longform-batched: {time.perf_counter() - t0:.1f} s")

    for entry, base, run, key in P5_ENTRIES:
        shapes, calls = results[f"p5_shapes_{run}"]
        if key is None:   # the alignment's first linear: M = the first window's tokens
            key = next((k for k in shapes if k[0] == "int8_matmul"
                        and k[1] == summaries[run]["align_tokens"]), None)
        check(key in shapes, f"phase5: {run} never called the {key} shape")
        count = calls[key].get(base, 0)   # the wrapper's launches at that shape
        check(count > 0, f"phase5: {run} never launched {base} at the {key} shape")
        results[entry] = {**time_p5_shape(f"{run} {entry}", key, shapes[key]),
                          "launches": count}
    for k in [k for k in results if k.startswith("p5_shapes_")]:
        del results[k]                      # the recorded inputs
    return summaries


# ---------------------------------------------------------------------------
# Phase 6 (slice 13): continuous batching, streaming, the serving service
# ---------------------------------------------------------------------------

# phase 6's tree: whisper-small's int8 tree cut to its first P6_LAYERS
# encoder and decoder layers (full width, `cut_layers`): every serving run's
# host loop and held checks grow with the depth, and the smoke's time limit
# holds the runs to this one
P6_LAYERS = 2
CB_BATCH, CB_REQUESTS, CB_TOKENS = 96, 384, 64   # bench.py's continuous_batching row
CB_GREEDY_ROWS = 48   # the first requests held against one greedy batch (`cb_yardsticks`)
CB_CHUNK, CB_LANES = 8, 24
CB_SCALE = 1.0 / 32767.0     # continuous batching's int16 wire (models/continuous.py)
# bench.py's streaming rows: 32 sessions of 60 s (steady) and 30 s (churn);
# here 16 sessions, steady takes 32 s, so that each session's window still
# slides once (past 30 s), and churn 16 s (its three churns, no slide), so
# that the passes fit the run's time
STREAMS, STEADY_S, CHURN_S, STREAM_CHUNK_S = 16, 32.0, 16.0, 0.5
# the held churn pass replays the first 12 of the timed pass's 32 rounds: the
# first of its three churns (at round 8) and 4 rounds of the sessions it
# opened, every kernel call held, its partials and the churned sessions'
# finals equal to the timed pass's
HELD_CHURN_ROUNDS = 12
SERVE_BATCH, SERVE_REQUESTS, UTT_S = 32, 128, 7.42   # bench.py's serve row
OPENLOOP_REQUESTS, OPENLOOP_LOAD, MULAW_REQUESTS = 96, 0.6, 32
LONG_S = 65.0                # one request the service splits into three windows
FLAC_WORKERS = 3             # processes encoding the serve runs' FLAC payloads
# kernels-line entries for the shapes phase 6 gives the kernels: (entry name,
# the KERNELS entry, the run whose held calls at that shape it counts and
# times, the shape key: `checked_kernel_calls`'s, or (kernel, batch) from
# `batch_calls`, or "pass2": continuous batching's int8 update at a position
# of the second 64-position pass with a slot's `start` in it)
P6_ENTRIES = [
    ("decode_self_attention_update_int8_start@cb-1152rows-pass2",
     "decode_self_attention_update_int8_start", "cb-small", "pass2"),
    ("decode_cross_attention_grouped_int8@cb-admitted", "decode_cross_attention_grouped_int8",
     "cb-small", ("grouped", "torch.int8", 1500, 1, CB_BATCH * 12)),
    ("decode_cross_attention_grouped_int8_wide@stream-60slots",
     "decode_cross_attention_grouped_int8_wide", "stream-steady",
     ("grouped", "torch.int8", 1500, 60, STREAMS * 12)),
    (f"decode_self_attention_update_int8_start@stream-{STREAMS * 12}rows",
     "decode_self_attention_update_int8_start", "stream-steady",
     ("decode_self_attention_update_int8", "torch.bfloat16", STREAMS * 12, 64, True)),
    ("int8_matmul@serve-b8-qkv-M8", "int8_matmul", "serve-flac", ("int8_matmul", 8, 768, 2304)),
    ("decode_cross_attention_grouped_int8@serve-b8", "decode_cross_attention_grouped_int8",
     "serve-flac", ("grouped", "torch.int8", 1500, 1, 96)),
    ("decode_self_attention_update_int8@serve-b8", "decode_self_attention_update_int8",
     "serve-flac", ("decode_self_attention_update_int8", "torch.bfloat16", 96, 64, False)),
    ("log_mel_cuda@serve-b8", "log_mel_cuda", "serve-flac", ("log_mel_cuda", 8)),
    ("encoder_attention@serve-b8", "encoder_attention", "serve-flac", ("encoder_attention", 8)),
    ("transpose_quant_kv@serve-b8", "transpose_quant_kv", "serve-flac", ("transpose_quant_kv", 8)),
    ("encoder_attention@serve-b32", "encoder_attention", "serve-flac",
     ("encoder_attention", 32)),
    ("transpose_quant_kv@serve-b32", "transpose_quant_kv", "serve-flac",
     ("transpose_quant_kv", 32)),
]


def batch_calls(sink: dict, calls: dict) -> list:
    """Patches that keep the first call's inputs of the mel (through the
    frontend, `features.preprocess`), the encoder attention and the cross-KV
    quantizer at each batch size in `sink` and count each kernel's launches
    at each in `calls`, read from its wrapper's counter (their
    `checked_kernel_calls` keys hold no batch)."""
    from openai_whisper_compression_tpu_torch.audio import features
    from openai_whisper_compression_tpu_torch.models import whisper

    counters = launch_counters()

    def wrap(mod, name, kernel):
        real = getattr(mod, name)
        wrapper, attr = counters[kernel]

        def fn(*a, **kw):
            key = (kernel, a[0].shape[0])
            sink.setdefault(key, a)
            before = getattr(wrapper, attr)
            out = real(*a, **kw)
            at = calls.setdefault(key, {})
            at[kernel] = at.get(kernel, 0) + getattr(wrapper, attr) - before
            return out
        return (mod, name, fn)

    return [wrap(features, "preprocess", "log_mel_cuda"),
            wrap(whisper, "encoder_attention", "encoder_attention"),
            wrap(whisper, "transpose_quant_kv", "transpose_quant_kv")]


class Background:
    """`fn()` on a thread of its own (CPU work that overlaps the card's);
    `result()` joins it and re-raises what it raised."""

    def __init__(self, fn):
        import threading

        self._out: dict = {}

        def run():
            try:
                self._out["value"] = fn()
            except BaseException as e:        # re-raised by result()
                self._out["error"] = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def result(self):
        self._thread.join()
        if "error" in self._out:
            raise self._out["error"]
        return self._out["value"]


# CPU f32 proofs of runs on the card (tie proofs, CPU references), queued by
# `later` and run by `run_later` on a thread beside phase 6's held passes
LATER: list = []
# the interpreter's thread switch interval while that thread runs (Python's
# default is 5 ms)
PROOF_SWITCH_S = 0.0005
# the f32 encoder states (fast frontend, on the card through the plain
# versions) of `waveforms(SEED, BATCH)` under whisper-small's int8 tree, by
# row: the tie proofs of unfused-int8, spec-* and verified-* decode that
# audio with that tree, and share them
SEED_ENCS: dict = {}


def later(label: str, fn) -> None:
    """Queue `fn()`, a CPU f32 proof of a run on the card that logs and
    checks, for `run_later`: it runs while the card runs phase 6's held
    passes, so no timed pass shares the host with it; a failed check fails
    the run when that thread is joined."""
    LATER.append((label, fn))


def card_ties(name: str, params32, arch, cfg, wav, got, want, first_gen: int,
              summary: dict, line, **kw) -> None:
    """`check_ties` now, in f32 on the card through the plain versions
    (`plain_kernels`; TF32 off: `main` sets it), as phases 7, 8 and 10
    prove theirs: `params32` the tree in f32 on the card, `wav` there too;
    no kernel launches. `summary["parted"]` gets the rows that parted and
    `line(parted)` is logged."""
    t0 = time.perf_counter()
    counters = zero_launches()
    with plain_kernels():
        summary["parted"] = check_ties(name, params32, arch, cfg, wav, got, want,
                                       first_gen, device=wav.device, **kw)
    launches = read_launches(counters)
    check(not any(launches.values()),
          f"{name}: the f32 recompute launched {launched(launches)}")
    log(f"{line(summary['parted'])} (f32 on the card through the plain versions, "
        f"{time.perf_counter() - t0:.1f} s, no kernel launched)")


@torch.inference_mode()
def run_later() -> dict:
    """Run the queued proofs in order (on the calling thread); returns the
    seconds of each."""
    secs = {}
    while LATER:
        label, fn = LATER.pop(0)
        t0 = time.perf_counter()
        fn()
        secs[label] = round(time.perf_counter() - t0, 1)
    return secs


def launched(launches: dict) -> dict:
    """The kernels a run launched, with their counts (for the log)."""
    return {k: v for k, v in launches.items() if v}


def padded_rows(rows, length: int, eot: int) -> torch.Tensor:
    """Token sequences as one (N, length) tensor, EOT past each row's end."""
    out = torch.full((len(rows), length), eot, dtype=torch.long)
    for i, r in enumerate(rows):
        out[i, : len(r)] = torch.as_tensor(np.asarray(r, np.int64))
    return out


def decode_exact(arch, calls: int, windows: int, steps: int, window_chunks: list,
                 kernel_windows: int = 0) -> dict:
    """Exact launch counts of `calls` encodes of whisper-small with int8
    weights and caches, `windows` windowed passes (the grouped kernel in the
    window's chunks of at most 8 slots a layer; the linears of the
    `kernel_windows` of them whose M is within `kernel_m_threshold()` 6 int8
    matmuls a layer, the others' past the kernels' M) and `steps` decode
    steps with a per-row `start` (grouped cross-attention, 6 int8 matmuls and
    the int8 update a layer)."""
    layers = arch.decoder_layers
    return {"log_mel_cuda": calls, "encoder_attention": arch.encoder_layers * calls,
            "transpose_quant_kv": 2 * layers * calls,
            "int8_matmul": 6 * layers * (steps + kernel_windows),
            "decode_cross_attention_grouped_int8":
                layers * (steps + windows * sum(c <= 4 for c in window_chunks)),
            "decode_cross_attention_grouped_int8_wide":
                layers * windows * sum(c > 4 for c in window_chunks),
            "decode_self_attention_update_int8_start": layers * steps}


@torch.inference_mode()
def run_cb_small(dev, arch, params, params_cpu, results: dict, after_timed=None) -> dict:
    """`ContinuousBatcher` at bench.py's continuous_batching row: batch 96,
    384 requests of ragged noise (x 0.35, 1-30 s, seed 1) staged as an int16
    pool by `stage()`, per-request caps lognormal(log 32, 0.55) in 2..64,
    chunk 8, 24 admit lanes, prefill disaggregation, EOT allowed. The three
    schedulers (wave, continuous, overlap), each timed, then each again with
    every kernel call held against its plain version (tokens equal to the
    timed run's); exact launch counts from each run's stage passes and
    device steps; tokens of the three equal or parted at a proven tie; the
    first CB_GREEDY_ROWS requests against one `make_transcribe_fn` batch at 64 tokens
    cut at each cap (`gen_tokens_of_row`); `fixed_equiv_rtfx`: the
    fixed-token decoder at the set's mean length (EOT suppressed), two
    timed batches; a float32 pool under transfer="int16" refused. The
    comparators (`cb_yardsticks`) run between the timed and the held runs,
    the tie proofs (`cb_ties`) on a thread beside the held runs, and
    `after_timed` is called as the held runs begin. Returns the summary and
    `finish()`, which joins the tie proofs into it."""
    from openai_whisper_compression_tpu_torch.config import DecodeConfig
    from openai_whisper_compression_tpu_torch.continuous import CBStats, ContinuousBatcher
    from openai_whisper_compression_tpu_torch.models import decode

    name, b, eot = "cb-small", CB_BATCH, arch.eos_token_id
    cfg = DecodeConfig(max_new_tokens=CB_TOKENS, **KV8)
    rng = np.random.default_rng(1)
    n = arch.max_source_positions * 2 * 160
    lens = rng.integers(16000, n, CB_REQUESTS)
    caps = np.clip(np.round(rng.lognormal(np.log(CB_TOKENS / 2), 0.55, CB_REQUESTS)),
                   2, CB_TOKENS).astype(int).tolist()
    wavs = [rng.standard_normal(int(ln)).astype(np.float32) * 0.35 for ln in lens]
    durations = (lens / 16000.0).tolist()
    cb = ContinuousBatcher(params, arch, cfg, batch=b, chunk=CB_CHUNK, admit_lanes=CB_LANES,
                           fast_mel=True, fast_gelu=True, transfer="int16", device=dev)
    t0 = time.perf_counter()
    pool = cb.stage(wavs)
    cb.warmup()
    torch.cuda.synchronize()
    log(f"phase6 {name}: {arch.name} cut to {arch.encoder_layers} encoder and "
        f"{arch.decoder_layers} decoder layers, int8 weights, int8 self-KV and cross-KV, batch {b}, "
        f"{CB_REQUESTS} requests of {lens.min() / 16000:.2f}-{lens.max() / 16000:.2f} s "
        f"({sum(durations):.1f} s), caps {min(caps)}-{max(caps)} (mean {np.mean(caps):.2f}), "
        f"chunk {CB_CHUNK}, {CB_LANES} admit lanes, stage_encode, int16 pool "
        f"{tuple(pool.shape)} {pool.dtype}, cache_len {cb.plan.cache_len}; stage + warmup "
        f"{time.perf_counter() - t0:.2f} s")
    pool_f32 = pool.float() * CB_SCALE          # what the admits decode
    try:
        cb.transcribe_all(pool_f32[:4])
        check(False, f"{name}: a float32 pool under transfer='int16' was accepted")
    except ValueError as e:
        log(f"phase6 {name}: a float32 pool under transfer='int16' raises: {e}")

    fg = cb.plan.p_len
    scheds = (("wave", {"wave": True}), ("continuous", {}), ("overlap", {"overlap": True}))
    name_u = "decode_self_attention_update_int8"
    runs, run_lens, summary = {}, {}, {}
    for held_on in (False, True):
        if held_on:
            summary.update(cb_yardsticks(dev, arch, params, cfg, cb, pool_f32, caps,
                                         durations, run_lens["wave"], results))
            want = summary.pop("greedy_want")
            # the CPU f32 tie proofs, then the earlier phases' queued proofs
            # (`later`), run on a thread while the held runs go, on all but
            # two of the cores (the held runs' host loop and the FLAC
            # encoders keep theirs)
            threads = torch.get_num_threads()
            torch.set_num_threads(max(1, threads - 2))
            # the proofs' one-row decodes are thousands of small ops, each
            # taking the GIL back from the held runs' host loop: at the
            # default 5 ms switch interval each waits up to that long
            switch = sys.getswitchinterval()
            sys.setswitchinterval(PROOF_SWITCH_S)
            ties = Background(lambda: (cb_ties(params_cpu, arch, cfg, pool_f32, runs, want,
                                               fg), run_later()))
            if after_timed is not None:
                after_timed()
        for what, kw in scheds:
            stats, shapes, calls, pass2 = CBStats(), {}, {}, {}
            cb.state = cb.fns["init"](params)     # every run from position 0
            with (checked_kernel_calls(shapes, calls, mel=True) if held_on
                  else contextlib.nullcontext({})) as held:
                real_u = getattr(decode, name_u)

                def rec(*a, start=None):   # an update at pass 2 with a start in it
                    if ("args" not in pass2 and a[0].is_cuda and a[-1] >= 64
                            and start is not None and int(start.max()) >= 64):
                        pass2["args"] = tuple(x.clone() if isinstance(x, torch.Tensor)
                                              else x for x in a) + (start.clone(),)
                    return real_u(*a, start=start)

                with patched((decode, name_u, rec)) if held_on else contextlib.nullcontext():
                    counters = zero_launches()
                    t0 = time.perf_counter()
                    toks = cb.transcribe_all(pool, stats=stats, max_new=caps,
                                             durations=durations, **kw)
                    wall = time.perf_counter() - t0
                    launches = read_launches(counters)
            steps, passes = stats.device_steps, stats.extra["stage_passes"]
            exact = decode_exact(arch, passes, 0, steps, [])
            check_launches(f"{name} {what}", launches, tuple(exact), exact)
            tokens = padded_rows(toks, fg + CB_TOKENS, eot)
            if held_on:
                check(torch.equal(tokens, runs[what]), f"{name} {what}: the held run's "
                      "tokens differ from the timed run's")
                log(f"phase6 {name} {what} held: wall {wall:.2f} s; "
                    f"{held_summary(held, shapes)}")
                if what == "continuous":
                    check("args" in pass2, f"{name}: no update at pass 2 with a start there")
                    results["p6_shapes_cb-small"] = (shapes, calls, pass2["args"],
                                                     launches[name_u + "_start"])
                continue
            runs[what], run_lens[what] = tokens, [len(t) for t in toks]
            snap = stats.snapshot()
            summary[what] = {"rtfx": stats.rtfx, "occupancy": stats.occupancy,
                             "device_steps": steps, "chunks": stats.chunks,
                             "stage_passes": passes, "rebases": stats.rebases,
                             "wall_s": wall, "gen_tokens": stats.gen_tokens,
                             **{k: snap[k] for k in ("t_admit_s", "t_chunk_dispatch_s",
                                                      "t_readback_s", "t_stage_s")}}
            log(f"phase6 {name} {what}: rtfx {stats.rtfx:.2f} (audio s / wall {wall:.4f} s), "
                f"occupancy {stats.occupancy:.4f}, device_steps {steps}, chunks "
                f"{stats.chunks}, stage_passes {passes}, rebases {stats.rebases}, admits "
                f"{stats.admits} in {stats.admit_passes} passes, gen_tokens "
                f"{stats.gen_tokens}; host phases: admit {snap['t_admit_s']} s, chunk "
                f"{snap['t_chunk_dispatch_s']} s, readback {snap['t_readback_s']} s, stage "
                f"{snap['t_stage_s']} s; launches {json.dumps(launched(launches))}")
            if what == "wave":
                summary["launches"] = launches
    summary["requests"] = CB_REQUESTS

    def finish() -> None:
        summary["parted"], secs = ties.result()
        torch.set_num_threads(threads)
        sys.setswitchinterval(switch)
        log(f"phase6 {name}: the earlier runs' CPU f32 proofs, seconds each: "
            f"{json.dumps(secs)}")

    return summary, finish


@torch.inference_mode()
def cb_yardsticks(dev, arch, params, cfg, cb, pool_f32, caps, durations, wave_lens,
                  results: dict) -> dict:
    """cb-small's comparators, run between its timed and its held runs:
    one greedy batch of the first CB_GREEDY_ROWS requests at 64 tokens, every kernel
    call held, cut at each request's cap (`gen_tokens_of_row`: the tokens
    the batcher must give them); the fixed-token decoder at the wave run's
    mean length (EOT suppressed) over two batches, timed
    (`fixed_equiv_rtfx`) and held."""
    from openai_whisper_compression_tpu_torch.evaluation.harness import make_transcribe_fn
    from openai_whisper_compression_tpu_torch.models.continuous import gen_tokens_of_row

    name, b, eot, fg = "cb-small", CB_BATCH, arch.eos_token_id, cb.plan.p_len
    fn = make_transcribe_fn(arch, cfg, fast_mel=True, fast_gelu=True, device=dev)
    shapes: dict = {}
    with checked_kernel_calls(shapes, mel=True) as held:
        g_tok, g_len = (x.cpu() for x in fn(params, pool_f32[:CB_GREEDY_ROWS]))
    log(f"phase6 {name} greedy batch: {held_summary(held, shapes)}")
    want = padded_rows([np.concatenate([np.asarray(cb.plan.prefix), gen_tokens_of_row(
        g_tok[r].numpy(), 0, fg, caps[r], eot)]) for r in range(CB_GREEDY_ROWS)],
        fg + CB_TOKENS, eot)

    mean_len = float(np.mean(wave_lens))
    eq_tokens = max(int(round(mean_len)) - fg, 1)
    cfg_eq = dataclasses.replace(cfg, max_new_tokens=eq_tokens, suppress_tokens=(eot,))
    fn_eq = make_transcribe_fn(arch, cfg_eq, fast_mel=True, fast_gelu=True, device=dev)
    fn_eq(params, pool_f32[:b])
    torch.cuda.synchronize()
    counters = zero_launches()
    t0 = time.perf_counter()
    outs = [fn_eq(params, pool_f32[k * b: (k + 1) * b])[0].cpu() for k in (1, 2)]
    eq_wall = time.perf_counter() - t0
    launches = read_launches(counters)
    exact = decode_launches(arch, [eq_tokens] * 2, [b] * 2)
    check_launches(f"{name} fixed-equiv", launches, tuple(exact), exact)
    shapes = {}
    with checked_kernel_calls(shapes, mel=True) as held:
        held_eq = [fn_eq(params, pool_f32[k * b: (k + 1) * b])[0].cpu() for k in (1, 2)]
    check(all(torch.equal(x, y) for x, y in zip(outs, held_eq)),
          f"{name}: the fixed-equiv held calls differ from the timed ones")
    eq_rtfx = float(sum(durations[b: 3 * b])) / eq_wall
    log(f"phase6 {name} fixed_equiv: {eq_tokens} tokens (the wave run's mean length "
        f"{mean_len:.2f} less the prefix), 2 batches of {b} in {eq_wall:.4f} s: "
        f"fixed_equiv_rtfx {eq_rtfx:.2f}; held: {held_summary(held, shapes)}")
    return {"fixed_equiv_rtfx": eq_rtfx, "fixed_equiv_tokens": eq_tokens,
            "greedy_want": want}


@torch.inference_mode()
def cb_ties(params_cpu, arch, cfg, pool_f32, runs: dict, want, fg: int) -> dict:
    """cb-small's token comparisons (`check_ties`, one CPU f32 encoder pass
    a request, shared): continuous against wave, overlap against
    continuous, the first CB_GREEDY_ROWS continuous requests against the greedy batch.
    Returns the rows parted in each."""
    name, encs, parted = "cb-small", {}, {}
    for a, bname in (("continuous", "wave"), ("overlap", "continuous")):
        parted[a] = check_ties(f"{name} {a} vs {bname}", params_cpu, arch, cfg, pool_f32,
                               runs[a], runs[bname], fg, encs=encs)
        log(f"phase6 {name}: {CB_REQUESTS - parted[a]} of {CB_REQUESTS} requests of "
            f"{a} equal {bname}'s tokens, {parted[a]} part at a proven tie")
    g = CB_GREEDY_ROWS
    parted["greedy"] = check_ties(f"{name} continuous vs greedy", params_cpu, arch, cfg,
                                  pool_f32, runs["continuous"][:g], want, fg, encs=encs)
    log(f"phase6 {name}: {g - parted['greedy']} of {g} requests equal one greedy_decode "
        f"batch at {CB_TOKENS} tokens cut at their caps, {parted['greedy']} part at a "
        "proven tie")
    return parted


def stream_audio(seconds: float, seed: int) -> list:
    """bench.py's streams: each of STREAMS sessions `seconds` of noise x 0.1
    in 0.5 s chunks, from one generator."""
    rng = np.random.default_rng(seed)
    chunk = int(STREAM_CHUNK_S * 16000)
    return [rng.standard_normal((int(seconds / STREAM_CHUNK_S), chunk)).astype(np.float32)
            * 0.1 for _ in range(STREAMS)]


def stream_pass(pool, audio: list, churn: bool, on_tick=None,
                rounds: int | None = None) -> dict:
    """One pass of bench.py's streaming row over `pool`: sessions fed 0.5 s
    chunks round-robin, a tick after every round; with `churn` a quarter of
    the sessions closed (their finals kept) and new ones opened every
    quarter of the run. `rounds`: stop after that many rounds (the churn
    schedule stays the whole run's) and close the live sessions. Returns
    every tick's partials, the finals, the sessions the churn closed, tick
    times, the wall and the closed count."""
    total = len(audio[0])
    churn_every = total // 4 if churn else 0
    live, next_id = list(range(STREAMS)), STREAMS
    for i in live:
        pool.open(i)
    ticks, tick_s, finals, churned = [], [], {}, []
    t0 = time.perf_counter()
    for c in range(total if rounds is None else min(rounds, total)):
        if churn_every and c > 0 and c % churn_every == 0:
            for _ in range(STREAMS // 4):
                sid = live.pop(0)
                finals[sid] = pool.close(sid)
                churned.append(sid)
                pool.open(next_id)
                live.append(next_id)
                next_id += 1
        for i in live:
            pool.feed(i, audio[i % STREAMS][c])
        tt = time.perf_counter()
        ticks.append(pool.tick())
        tick_s.append(time.perf_counter() - tt)
        if on_tick is not None:
            on_tick(ticks[-1])
    for i in live:
        finals[i] = pool.close(i)
    wall = time.perf_counter() - t0
    return {"ticks": ticks, "tick_s": tick_s, "finals": finals, "churned": churned,
            "wall": wall, "closed": len(finals)}


@torch.inference_mode()
def run_streams(dev, arch, params, params_cpu, results: dict, before_timed=None) -> dict:
    """`StreamingPool` at bench.py's streaming rows cut to STREAMS sessions, agreement 2,
    min_step 1 s, timestamps on, 25 tokens, int8 caches, a 32-token prompt
    window. stream-steady: STEADY_S s streams (noise x 0.1, seed 0); stream-churn:
    CHURN_S s streams, a quarter of the sessions closed and reopened every
    quarter of the run, on the same pool. Each run once with every kernel
    call held, every synced mirror row checked bit for bit against its host
    window (zero past it, a reused row's too) and committed text never
    retracting, then timed (after `before_timed`), its partials and finals
    equal to the held pass's; exact
    launch counts from the step calls, windows and decode steps each pass
    made. After the held steady pass two of its streams run again through
    standalone transcribers on the pool's step, held too: every decode
    equal to the pool's and the finals equal, or the first decode where
    they part a proven tie (CPU f32, the streaming step's f32 DFT and exact
    GELU), where that stream's comparison ends."""
    from openai_whisper_compression_tpu_torch import streaming
    from openai_whisper_compression_tpu_torch.config import DecodeConfig
    from openai_whisper_compression_tpu_torch.evaluation.tokenizer import default_tokenizer
    from openai_whisper_compression_tpu_torch.models import speculative
    from openai_whisper_compression_tpu_torch.models.decode import forced_prefix
    from openai_whisper_compression_tpu_torch.ops.linear import kernel_m_threshold

    cfg = DecodeConfig(max_new_tokens=NEW_TOKENS, notimestamps=False, **KV8)
    tok = default_tokenizer(arch)
    pool = streaming.StreamingPool(params, arch, tok, cfg, max_streams=STREAMS,
                                   agreement=2, min_step_s=1.0, device=dev)
    fg = pool._pw + len(forced_prefix(arch, cfg))
    window = fg + NEW_TOKENS
    chunks = [min(8, window - j) for j in range(0, window, 8)]
    counts = {"calls": 0, "windows": 0, "steps": 0, "kernel_windows": 0}
    # recorded decodes of the compared streams: sid -> [(wav, prompt, plen, tokens)]
    rec = {"on": False, "pool": {}, "solo": {}, "closing": None}
    real_batched, real_single, real_close = pool._batched_step, pool._single_step, pool.close
    real_step, real_window = speculative.decoder_step, speculative.verify_window

    def keep(sink, s, wav, prompt, plen, out, r=0):
        sink[s].append((torch.as_tensor(wav[r: r + 1]).clone(), np.asarray(prompt[r: r + 1]),
                        np.asarray(plen[r: r + 1]), out[r: r + 1, :-2].cpu()))

    def batched(params_, wav, prompt, plen, draft, dlen, active):
        counts["calls"] += 1
        out = real_batched(params_, wav, prompt, plen, draft, dlen, active)
        if rec["on"]:
            for s in rec["pool"]:
                r = pool._row_of.get(s)
                if r is not None and bool(active[r]):
                    keep(rec["pool"], s, wav, prompt, plen, out, r)
        return out

    def single(params_, wav, prompt, plen, draft, dlen, active):
        counts["calls"] += 1
        out = real_single(params_, wav, prompt, plen, draft, dlen, active)
        if rec["on"] and rec["closing"] in rec["pool"]:      # a compared session's flush
            keep(rec["pool"], rec["closing"], wav, prompt, plen, out)
        return out

    def close(sid):
        rec["closing"] = sid
        try:
            return real_close(sid)
        finally:
            rec["closing"] = None

    def solo_step(s):
        def fn(params_, wav, prompt, plen, draft, dlen, active):
            out = single(params_, wav, prompt, plen, draft, dlen, active)
            keep(rec["solo"], s, wav, prompt, plen, out)
            return out
        return fn

    def step(*a, **kw):
        counts["steps"] += 1
        return real_step(*a, **kw)

    def win(params_, arch_, window, *a, **kw):
        counts["windows"] += 1
        counts["kernel_windows"] += window.numel() <= kernel_m_threshold()
        return real_window(params_, arch_, window, *a, **kw)

    def solo_compare(s: int, chunks_s, final) -> str:
        """Stream s alone on the pool's step, every kernel call held, fed
        as its session was; its decodes against the session's recorded ones
        until the first that parts (a proven tie ends the comparison), else
        the finals equal."""
        pooled, alone = rec["pool"][s], rec["solo"][s]
        st = streaming.StreamingTranscriber(params, arch, tok, cfg, agreement=2,
                                            min_step_s=1.0, step_fn=solo_step(s), device=dev)
        shapes: dict = {}

        def parted() -> int | None:
            return next((i for i, (x, y) in enumerate(zip(pooled, alone))
                         if not torch.equal(x[3], y[3])), None)

        with checked_kernel_calls(shapes, mel=True) as held:
            for c in chunks_s:
                st.feed(c)
                if parted() is not None:
                    break
            else:
                out = st.flush()
        first = parted()
        if first is None:
            check(out == final and len(pooled) == len(alone),
                  f"stream {s}: alone its finals differ from the pool's with every decode "
                  f"equal ({len(pooled)} and {len(alone)} decodes)")
            log(f"phase6 stream-steady: stream {s} alone on the pool's step: {len(alone)} "
                f"decodes, each equal to the pool's; finals equal; {held_summary(held, shapes)}")
            return "equal"
        (w1, p1, l1, t1), (w2, p2, l2, t2) = pooled[first], alone[first]
        check(torch.equal(w1.cpu(), w2.cpu()) and np.array_equal(p1, p2)
              and np.array_equal(l1, l2), f"stream {s}: decode {first} had other inputs alone")
        check_ties(f"stream-steady stream {s} decode {first}", params_cpu, arch, cfg,
                   w1.float(), t1, t2, fg, prompt=torch.from_numpy(p1).long(),
                   lens=torch.from_numpy(l1).long(), fast=False)
        log(f"phase6 stream-steady: stream {s} alone on the pool's step parts from the "
            f"pool at decode {first} of {len(pooled)}, at a proven tie; "
            f"{held_summary(held, shapes)}")
        return f"tie at decode {first}"

    pool._batched_step, pool._single_step, pool.close = batched, single, close
    # warm the batched step on a throwaway session (bench.py's warmup)
    pool.open("warm")
    pool.feed("warm", np.random.default_rng(9).standard_normal(32000).astype(np.float32) * 0.1)
    pool.tick()
    pool.close("warm")
    summaries = {}
    runs = (("stream-steady", STEADY_S, False), ("stream-churn", CHURN_S, True))
    audio = {name: stream_audio(seconds, 0) for name, seconds, _ in runs}
    passes: dict = {}
    # the held passes first, the timed passes after `before_timed` (which
    # waits for work that would share the host with them)
    for held_on in (True, False):
        if not held_on and before_timed is not None:
            before_timed()
        for name, seconds, churn in runs:
            pool.reset_stats()
            counts.update(calls=0, windows=0, steps=0, kernel_windows=0)
            shapes, kcalls, committed = {}, {}, {}
            synced = {"rows": 0, "reused": 0}
            if held_on and not churn:     # the compared streams' decodes
                rec.update(on=True, pool={0: [], 1: []}, solo={0: [], 1: []})
            real_sync = pool._sync_mirrors

            def sync(rows):
                real_sync(rows)
                for sid, r in rows:
                    w = pool.sessions[sid]._window()
                    m = pool._mirror[r].cpu().numpy()
                    check(np.array_equal(m[: len(w)], w) and not m[len(w):].any()
                          and pool._mlen[r] == len(w),
                          f"{name}: session {sid}'s mirror row {r} differs from its window")
                    synced["rows"] += 1
                    synced["reused"] += sid >= STREAMS     # a churned-in session's row

            def on_tick(out):
                for sid, o in out.items():
                    check(o["committed"].startswith(committed.get(sid, "")),
                          f"{name}: session {sid}'s committed text retracted")
                    committed[sid] = o["committed"]

            if held_on:
                pool._sync_mirrors = sync
            try:
                with patched((speculative, "decoder_step", step),
                             (speculative, "verify_window", win)), \
                        (checked_kernel_calls(shapes, kcalls, mel=True) if held_on
                         else contextlib.nullcontext({})) as held:
                    counters = zero_launches()
                    res = stream_pass(pool, audio[name], churn, on_tick if held_on else None,
                                      HELD_CHURN_ROUNDS if held_on and churn else None)
                    torch.cuda.synchronize()
                    launches = read_launches(counters)
            finally:
                pool._sync_mirrors = real_sync
                rec["on"] = False
            stats = pool.stats()
            exact = decode_exact(arch, counts["calls"], counts["windows"], counts["steps"],
                                 chunks, counts["kernel_windows"])
            check_launches(f"{name}{' held' if held_on else ''}", launches, tuple(exact),
                           exact)
            check(counts["windows"] == 2 * counts["calls"],
                  f"{name}: {counts['windows']} windows for {counts['calls']} step calls")
            res.update(stats=stats, launches=launches, counts=dict(counts))
            passes[name, held_on] = res
            if held_on:
                check(synced["rows"] >= stats["decodes"] and (synced["reused"] > 0) == churn,
                      f"{name}: {synced} mirror rows checked for {stats['decodes']} decodes")
                results[f"p6_shapes_{name}"] = (shapes, kcalls)
                log(f"phase6 {name} held ({len(res['ticks'])} of {len(audio[name][0])} "
                    f"rounds): wall {res['wall']:.2f} s; {synced['rows']} synced "
                    f"mirror rows ({synced['reused']} of reused rows) equal to their host "
                    f"windows and zero past them; committed text never retracted; "
                    f"{held_summary(held, shapes)}")
                if not churn:
                    alone = {s: solo_compare(s, audio[name][s], res["finals"][s]) for s in (0, 1)}
                continue
            h = passes[name, True]
            same = (res["ticks"][: len(h["ticks"])] == h["ticks"] if churn
                    else res["ticks"] == h["ticks"])
            for sid in (h["churned"] if churn else res["finals"]):
                same = same and res["finals"][sid] == h["finals"][sid]
            check(same and (churn or res["finals"] == h["finals"]),
                  f"{name}: the timed pass's partials or finals differ from the held pass's")
            stats, ts = res["stats"], np.asarray(res["tick_s"]) * 1e3
            audio_s = stats["audio_seconds"]
            acc = (stats["draft_accepted"] / stats["draft_proposed"]
                   if stats["draft_proposed"] else 0.0)
            summ = {"aggregate_rtfx": audio_s / res["wall"], "device_rtfx": stats["rtfx"],
                    "tick_p50_ms": float(np.percentile(ts, 50)),
                    "tick_p95_ms": float(np.percentile(ts, 95)),
                    "occupancy": stats["mean_batch_occupancy"], "draft_accept_rate": acc,
                    "sessions_closed": res["closed"], "batched_calls": stats["batched_calls"],
                    "step_calls": res["counts"]["calls"], "decode_steps": res["counts"]["steps"],
                    "wall_s": res["wall"], "launches": launches}
            if not churn:
                summ.update({f"stream{s}_alone": v for s, v in alone.items()})
            check(all(isinstance(f["committed"], str) and f["pending"] == ""
                      for f in res["finals"].values()) and len(res["finals"]) == res["closed"],
                  f"{name}: a closed session returned no finals")
            log(f"phase6 {name}: {STREAMS} sessions x {seconds:.0f} s ({audio_s:.1f} s of "
                f"audio) in {res['wall']:.4f} s: aggregate_rtfx {summ['aggregate_rtfx']:.2f}, "
                f"device_rtfx {summ['device_rtfx']:.2f}, tick p50 {summ['tick_p50_ms']:.1f} "
                f"ms p95 {summ['tick_p95_ms']:.1f} ms, occupancy {summ['occupancy']:.4f}, "
                f"draft_accept_rate {acc:.4f}, sessions_closed {res['closed']} (each returned "
                f"its finals), {stats['batched_calls']} batched calls, "
                f"{res['counts']['calls']} step calls ({res['counts']['steps']} decode steps); "
                f"partials and finals equal to the held pass's"
                + (f" (its {len(h['ticks'])} rounds and {len(h['churned'])} churned "
                   "sessions)" if churn else "") + "; launches "
                f"{json.dumps(launched(launches))}")
            summaries[name] = summ
    pool._batched_step, pool._single_step, pool.close = real_batched, real_single, real_close
    return summaries


def flac_payloads(wavs: list):
    """Start encoding `wavs` to FLAC (the serving wire's client side,
    `audio.flac_encode.encode_waveform`, pure Python) in FLAC_WORKERS
    spawned processes; returns (executor, futures). The caller shuts the
    executor down."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from openai_whisper_compression_tpu_torch.audio.flac_encode import encode_waveform

    ex = ProcessPoolExecutor(FLAC_WORKERS, mp_context=multiprocessing.get_context("spawn"))
    return ex, [ex.submit(encode_waveform, w) for w in wavs]


def serve_pass(dev, arch, params, fn, cfg, what: str, transfer: str, plan, held_on: bool,
               direct: dict) -> dict:
    """One `TranscriptionService` pass at batch 32 (buckets 8, 16, 32),
    max_wait 5 ms, pipeline 2: warmup, then `plan(svc)` -> (futures, timed
    wall) with launch counts zeroed after the warmup, the service closed in
    any case. Every batch's wire rows and outputs are recorded; each batch's
    tokens must equal a direct call of `fn` on the same rows (decoded as the
    wire decodes them), each request's ids must be its row's, and launches
    exact from the batches' buckets (25 steps each, EOT suppressed)."""
    from openai_whisper_compression_tpu_torch.evaluation.tokenizer import default_tokenizer
    from openai_whisper_compression_tpu_torch.serving import (PCM16_WIRE_SCALE,
                                                              TranscriptionService,
                                                              mulaw_decode)

    svc = TranscriptionService(params, arch, default_tokenizer(arch), cfg,
                               batch_size=SERVE_BATCH, max_wait_ms=5, transcribe_fn=fn,
                               transfer=transfer, pipeline=2, device=dev)
    batches, shapes, kcalls, firsts, bcalls = [], {}, {}, {}, {}
    try:
        svc.warmup()
        torch.cuda.synchronize()
        real_fn, real_fin = svc._fn, svc._finalize

        def fn_rec(p, wire):
            out = real_fn(p, wire)
            batches.append({"wire": np.array(wire), "out": out, "items": None})
            return out

        def fin_rec(entry):
            for b_ in batches:
                if b_["out"][0] is entry[2]:
                    b_["items"] = [(it[2], it[4]) for it in entry[0]]
                    b_["failed"] = set(entry[1])
            return real_fin(entry)

        svc._fn, svc._finalize = fn_rec, fin_rec
        with (checked_kernel_calls(shapes, kcalls, mel=True) if held_on
              else contextlib.nullcontext({})) as held, \
                (patched(*batch_calls(firsts, bcalls)) if held_on
                 else contextlib.nullcontext()):
            counters = zero_launches()
            futs, wall = plan(svc)
            svc.close(timeout=600)
            torch.cuda.synchronize()
            launches = read_launches(counters)
    finally:
        svc.close(timeout=600)
    check(not svc._worker.is_alive(), f"{what}: the service's worker outlived close()")
    buckets = [b_["wire"].shape[0] for b_ in batches]
    exact = decode_launches(arch, [NEW_TOKENS] * len(batches), buckets)
    check_launches(what, launches, tuple(exact), exact)
    decode_wire = {"int16": lambda w: w.float() * PCM16_WIRE_SCALE, "mulaw": mulaw_decode,
                   "float32": lambda w: w.float()}[transfer]
    row_ids: dict = {}
    for b_ in batches:
        wire = torch.from_numpy(b_["wire"]).to(dev)
        tokens, lengths = (x.cpu() for x in b_["out"][:2])
        key = b_["wire"].tobytes()
        if key not in direct:
            direct[key] = tuple(x.cpu() for x in fn(params, decode_wire(wire))[:2])
        check(torch.equal(direct[key][0], tokens) and torch.equal(direct[key][1], lengths),
              f"{what}: a batch's tokens differ from a direct call on its rows")
        check(b_["items"] is not None, f"{what}: a batch was never finalized")
        for slot, (fut, internal) in enumerate(b_["items"]):
            ids = tokens[slot, 4: int(lengths[slot])]
            row_ids[id(fut)] = ids[ids != arch.eos_token_id].tolist()
    stats = svc.stats.snapshot()
    if held_on:
        log(f"phase6 {what} held: {held_summary(held, shapes)}")
    return {"futs": futs, "wall": wall, "stats": stats, "buckets": buckets,
            "launches": launches, "batches": batches, "row_ids": row_ids,
            "shapes": (shapes, kcalls, firsts, bcalls)}


@torch.inference_mode()
def run_serving(dev, arch, params, flac: tuple, results: dict) -> dict:
    """`TranscriptionService` at bench.py's serve rows, `make_transcribe_fn`
    at the headline decode (int8 caches, 25 tokens, EOT suppressed):
    serve-flac: 128 requests of 7.42 s (noise x 0.1, seed 0) FLAC-encoded on
    the client, the int16 wire, closed loop, then one batch with a corrupt
    FLAC stream, a good one and a 65 s request (three windows); serve-openloop:
    96 of them paced at 60% of serve-flac's e2e_rtfx; serve-mulaw: 32 on the
    mu-law wire beside the float32 wire. Each timed, then again with every
    kernel call held; every batch equal to a direct call on its rows, every
    request's tokens its row's, exact launch counts; the corrupt stream fails
    only its own request; the 65 s request comes back in three chunks equal
    to their windows' direct calls."""
    from openai_whisper_compression_tpu_torch.audio.flac import parse_stream_info
    from openai_whisper_compression_tpu_torch.config import DecodeConfig
    from openai_whisper_compression_tpu_torch.evaluation.harness import make_transcribe_fn

    cfg = DecodeConfig(max_new_tokens=NEW_TOKENS, suppress_tokens=(arch.eos_token_id,), **KV8)
    fn = make_transcribe_fn(arch, cfg, fast_mel=True, fast_gelu=True, device=dev)
    ex, pending = flac
    wavs_all = flac_waves()
    t0 = time.perf_counter()
    payloads = [f.result(timeout=600) for f in pending]
    ex.shutdown(wait=True)
    log(f"phase6 serve: {len(payloads)} FLAC payloads ({sum(map(len, payloads)) / 1e6:.2f} MB, "
        f"{FLAC_WORKERS} encoding processes) ready after a further "
        f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(5)
    long_wav = rng.standard_normal(int(LONG_S * 16000)).astype(np.float32) * 0.1
    good = payloads[0]
    _, off = parse_stream_info(good)
    corrupt = good[: off + 2]
    direct: dict = {}
    summaries = {}

    def closed_loop(svc):
        t0 = time.perf_counter()
        futs = [svc.submit_flac(p) for p in payloads]
        for f in futs:
            f.result(timeout=600)
        wall = time.perf_counter() - t0
        extra = [svc.submit_flac(corrupt), svc.submit_flac(good), svc.submit(long_wav)]
        for f in extra[1:]:
            f.result(timeout=600)
        return futs + extra, wall

    e2e = None
    for held_on in (False, True):
        res = serve_pass(dev, arch, params, fn, cfg, "serve-flac", "int16", closed_loop,
                         held_on, direct)
        futs = res["futs"]
        *main, f_bad, f_good, f_long = futs
        try:
            f_bad.result(timeout=60)
            check(False, "serve-flac: the corrupt FLAC stream did not fail")
        except Exception as e:         # its own request only
            check("FLAC" in str(e), f"serve-flac: the corrupt stream failed with {e!r}")
        for f in main + [f_good]:
            check(f.result()["tokens"] == res["row_ids"][id(f)],
                  "serve-flac: a request's tokens are not its batch row's")
        check(f_good.result()["tokens"] == main[0].result()["tokens"],
              "serve-flac: the co-riding good stream differs from its first submission")
        long_res = f_long.result()
        windows = [it for b_ in res["batches"] for it in b_["items"] if it[1]]
        check(long_res["num_chunks"] == 3 and len(windows) == 3
              and long_res["tokens"] == sum((res["row_ids"][id(w[0])] for w in windows), []),
              f"serve-flac: the {LONG_S:.0f} s request's chunks differ from their windows'")
        st = res["stats"]
        n_audio = len(main) * UTT_S
        if not held_on:
            e2e = n_audio / res["wall"]
            summaries["serve-flac"] = {
                "e2e_rtfx": e2e, "busy_rtfx": st["rtfx"], "occupancy": st["mean_batch_occupancy"],
                "latency_p50_ms": st["latency_p50_ms"], "latency_p95_ms": st["latency_p95_ms"],
                "buckets": res["buckets"], "wall_s": res["wall"], "launches": res["launches"]}
            log(f"phase6 serve-flac: {len(main)} requests of {UTT_S} s on the FLAC wire "
                f"(int16 to the card) in {res['wall']:.4f} s: e2e_rtfx {e2e:.2f}, busy_rtfx "
                f"{st['rtfx']:.2f}, occupancy {st['mean_batch_occupancy']:.4f}, latency p50 "
                f"{st['latency_p50_ms']:.1f} ms p95 {st['latency_p95_ms']:.1f} ms (the "
                f"follow-up batch included), buckets {res['buckets']}; the corrupt stream "
                f"failed alone; the {LONG_S:.0f} s request in 3 chunks equal to their "
                f"windows' direct calls; launches {json.dumps(launched(res['launches']))}")
        else:
            results["p6_shapes_serve-flac"] = res["shapes"]

    interval = UTT_S / (OPENLOOP_LOAD * e2e)

    def open_loop(svc):
        t0 = time.perf_counter()
        futs = []
        for i, p in enumerate(payloads[:OPENLOOP_REQUESTS]):
            target = t0 + i * interval
            now = time.perf_counter()
            if target > now:
                time.sleep(target - now)
            futs.append(svc.submit_flac(p))
        for f in futs:
            f.result(timeout=600)
        return futs, time.perf_counter() - t0

    for held_on in (False, True):
        res = serve_pass(dev, arch, params, fn, cfg, "serve-openloop", "int16", open_loop,
                         held_on, direct)
        for f in res["futs"]:
            check(f.result()["tokens"] == res["row_ids"][id(f)],
                  "serve-openloop: a request's tokens are not its batch row's")
        if not held_on:
            st = res["stats"]
            summaries["serve-openloop"] = {
                "offered_rtfx": OPENLOOP_LOAD * e2e, "latency_p50_ms": st["latency_p50_ms"],
                "latency_p95_ms": st["latency_p95_ms"],
                "occupancy": st["mean_batch_occupancy"], "busy_rtfx": st["rtfx"],
                "buckets": sorted(set(res["buckets"])), "batches": len(res["buckets"]),
                "wall_s": res["wall"], "launches": res["launches"]}
            log(f"phase6 serve-openloop: {OPENLOOP_REQUESTS} requests offered at "
                f"{OPENLOOP_LOAD * e2e:.2f}x real time ({OPENLOOP_LOAD:.0%} of serve-flac's "
                f"e2e_rtfx, one every {interval * 1e3:.2f} ms) in {res['wall']:.4f} s: latency "
                f"p50 {st['latency_p50_ms']:.1f} ms p95 {st['latency_p95_ms']:.1f} ms, "
                f"occupancy {st['mean_batch_occupancy']:.4f}, {len(res['buckets'])} batches, "
                f"buckets used {sorted(set(res['buckets']))}; launches "
                f"{json.dumps(launched(res['launches']))}")

    waves = wavs_all[:MULAW_REQUESTS]
    toks = {}
    for transfer in ("float32", "mulaw"):
        def burst(svc):
            t0 = time.perf_counter()
            futs = [svc.submit(w) for w in waves]
            for f in futs:
                f.result(timeout=600)
            return futs, time.perf_counter() - t0

        for held_on in (False, True):
            res = serve_pass(dev, arch, params, fn, cfg, f"serve-mulaw ({transfer} wire)",
                             transfer, burst, held_on, direct)
            got = [f.result()["tokens"] for f in res["futs"]]
            check(all(g == res["row_ids"][id(f)] for g, f in zip(got, res["futs"])),
                  f"serve-mulaw: a {transfer} request's tokens are not its batch row's")
            if not held_on:
                toks[transfer] = got
                mulaw_launches = res["launches"]
    same = sum(a == b for a, b in zip(toks["float32"], toks["mulaw"]))
    summaries["serve-mulaw"] = {"requests": MULAW_REQUESTS, "equal_share": same / MULAW_REQUESTS,
                                "launches": mulaw_launches}
    log(f"phase6 serve-mulaw: {same} of {MULAW_REQUESTS} requests on the mu-law wire "
        f"({same / MULAW_REQUESTS:.4f}) have the float32 wire's tokens (lossy by design: "
        "no hold)")
    return summaries


def flac_waves() -> list:
    """bench.py's serve requests: SERVE_REQUESTS clips of 7.42 s of noise x
    0.1 from one generator (seed 0)."""
    rng = np.random.default_rng(0)
    return [rng.standard_normal(int(UTT_S * 16000)).astype(np.float32) * 0.1
            for _ in range(SERVE_REQUESTS)]


@torch.inference_mode()
def time_p6_shape(dev, what: str, key, args) -> dict:
    """A kernel at a shape phase 6 gave it, on the first held call's inputs
    (the mel on seeded clips of that batch), against its plain version,
    timed beside it and its bound."""
    if key[0] == "log_mel_cuda":
        return check_mel(dev, torch.Generator(device=dev).manual_seed(SEED), key[1],
                         torch.bfloat16)
    if key == "pass2":
        return time_p5_shape(what, ("update",), args)
    return time_p5_shape(what, key, args)


def phase6(dev, arch, params, results: dict, between=None) -> dict:
    """The slice-13 runs (module docstring), each run's seconds printed; then
    the P6_ENTRIES shapes timed. `between()` runs after the held stream
    passes, beside the queued CPU proofs, before they are joined (phase 7's
    held part, phase 11 and phase 10). Returns the runs' summaries."""
    from openai_whisper_compression_tpu_torch.models.params import tree_to

    params_cpu = tree_to(params, "cpu", torch.float32)
    summaries = {}
    # the serve runs' FLAC payloads encode on the host's other cores while
    # cb-small's held runs go (after its timed runs, before its CPU f32 ties)
    flac: list = []
    try:
        t0 = time.perf_counter()
        summaries["cb-small"], finish_cb = run_cb_small(
            dev, arch, params, params_cpu, results,
            after_timed=lambda: flac.extend(flac_payloads(flac_waves())))
        log(f"phase6 cb-small runs: {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()

        def before_timed():   # no CPU work beside the timed stream passes
            if between is not None:
                t1 = time.perf_counter()
                between()
                log(f"phase7 held part, phase 11 and phase 10, beside the queued CPU "
                    f"proofs: {time.perf_counter() - t1:.1f} s")
            t1 = time.perf_counter()
            finish_cb()
            log(f"phase6 cb-small tie proofs and the queued CPU proofs joined after a "
                f"further {time.perf_counter() - t1:.1f} s")

        summaries.update(run_streams(dev, arch, params, params_cpu, results, before_timed))
        log(f"phase6 stream-steady and stream-churn: {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        summaries.update(run_serving(dev, arch, params, flac, results))
        log(f"phase6 serve-flac, serve-openloop, serve-mulaw: "
            f"{time.perf_counter() - t0:.1f} s")
    finally:
        if flac:
            flac[0].shutdown(wait=True, cancel_futures=True)

    for entry, base, run, key in P6_ENTRIES:
        if run == "cb-small":
            shapes, calls, pass2, n_upd = results["p6_shapes_cb-small"]
            if key == "pass2":
                args, count = pass2, n_upd
            else:
                check(key in shapes, f"phase6: {run} never called the {key} shape")
                args, count = shapes[key], calls[key]
        elif run.startswith("stream"):
            shapes, calls = results[f"p6_shapes_{run}"]
            check(key in shapes, f"phase6: {run} never called the {key} shape")
            args, count = shapes[key], calls[key]
        else:
            shapes, calls, firsts, bcalls = results[f"p6_shapes_{run}"]
            src, cnt = ((firsts, bcalls) if len(key) == 2 else (shapes, calls))
            check(key in src, f"phase6: {run} never called the {key} shape")
            args, count = src[key], cnt[key]
        if key != "pass2":                # the wrapper's launches at that shape
            count = count.get(base, 0)
            check(count > 0, f"phase6: {run} never launched {base} at the {key} shape")
        results[entry] = {**time_p6_shape(dev, f"{run} {entry}", key, args),
                          "launches": count}
    for k in [k for k in results if k.startswith("p6_shapes_")]:
        del results[k]
    return summaries


# ---------------------------------------------------------------------------
# Phase 7: the presets (`sweep/presets.py`) on the card
# ---------------------------------------------------------------------------

PRESET_UTT_S = 7.42          # bench.py --presets' audio per utterance (AVG_UTT_SECONDS)
PRESET_TS_S = 60.0           # tiny_fp32_greedy's timestamped stream
LONGFORM_CLIPS = 8           # small_fp16_beam5_longform: 8 x 30 s joined, batch_size 8
AGREE_CLIPS = 8              # model_agreement's clips
REF_ROWS = 4                 # rows of a preset recomputed in f32 (card or CPU)
# the presets phase 7 runs: (row name, the preset, the model it builds, batch,
# DecodeConfig switches of the run, the kernels of its path). The largev3
# and turbo rows are bench.py --presets' (bench.py:818-826); tiny and the
# f16 long-form one only BASELINE_PRESETS has. bench.py's small_int8 and
# medium_int4_kv8 rows are phase 2's int8-kv and medium-int4 runs.
P7_RUNS = [
    ("largev3_s50_int8_ckv4", "largev3_structured50_int8", "large-v3", 48,
     {"kv_int8": True, "cross_kv_int4": True},
     ("log_mel_cuda", "encoder_attention", "int8_matmul",
      "decode_cross_attention_grouped_int4", "decode_self_attention_update_int8")),
    ("turbo_int8", "turbo_int8", "large-v3-turbo", 64, KV8, ("int8_matmul",) + DECODE_KERNELS),
    ("tiny_fp32_greedy", "tiny_fp32_greedy", "tiny", 16, {},
     ("log_mel_cuda", "encoder_attention_f32", "decode_cross_attention_grouped_f32",
      "decode_self_attention_update_f32")),
    ("small_fp16_beam5_longform", "small_fp16_beam5_longform", "small", LONGFORM_CLIPS,
     {"beam_size": 5},
     ("log_mel_cuda", "encoder_attention_f16", "decode_cross_attention_grouped_f16",
      "decode_cross_attention_grouped_f16_wide", "decode_self_attention_update_f16")),
]
# kernels-line entries for the shapes only phase 7 gives the kernels: (entry
# name, the KERNELS entry, the run whose held calls at that shape it counts
# and times, the shape key of `checked_kernel_calls`, None matching any value)
P7_ENTRIES = [
    ("encoder_attention@largev3-s50-10heads", "encoder_attention", "largev3_s50_int8_ckv4",
     ("encoder_attention", 10, 1500)),
    ("encoder_attention@turbo-20heads", "encoder_attention", "turbo_int8",
     ("encoder_attention", 20, 1500)),
    ("log_mel_cuda@128mels-b48", "log_mel_cuda", "largev3_s50_int8_ckv4", ("log_mel_cuda", 48)),
    ("log_mel_cuda@128mels-b64", "log_mel_cuda", "turbo_int8", ("log_mel_cuda", 64)),
    ("int8_matmul@largev3-s50-o-K640", "int8_matmul", "largev3_s50_int8_ckv4",
     ("int8_matmul", 48, 640, 1280)),
    ("int8_matmul@largev3-s50-fc2-K2560", "int8_matmul", "largev3_s50_int8_ckv4",
     ("int8_matmul", 48, 2560, 1280)),
    ("transpose_quant_kv@turbo-1280", "transpose_quant_kv", "turbo_int8",
     ("transpose_quant_kv", 1500, 1280)),
    ("decode_cross_attention_grouped_int4@largev3-s50-480rows",
     "decode_cross_attention_grouped_int4", "largev3_s50_int8_ckv4",
     ("grouped", None, 1500, 1, 480)),
    ("decode_self_attention_update_int8@largev3-s50-480rows",
     "decode_self_attention_update_int8", "largev3_s50_int8_ckv4",
     ("decode_self_attention_update_int8", "torch.bfloat16", 480, None, False)),
    ("decode_self_attention_update_int8@turbo-1280rows", "decode_self_attention_update_int8",
     "turbo_int8", ("decode_self_attention_update_int8", "torch.bfloat16", 1280, None, False)),
    ("log_mel_cuda@f32-b8", "log_mel_cuda", "small_fp16_beam5_longform", ("log_mel_cuda", 8)),
    ("log_mel_cuda@f32-b1", "log_mel_cuda", "tiny_fp32_greedy ts", ("log_mel_cuda", 1)),
]


def preset_of(name: str):
    """The `sweep.presets` preset of a P7_RUNS row; turbo_int8 (a bench.py
    row, not a preset of the module) is int8 weights on large-v3-turbo."""
    from openai_whisper_compression_tpu_torch.sweep.presets import PRESETS, Preset, _quant

    if name == "turbo_int8":
        return Preset("turbo_int8", "large-v3-turbo", "bfloat16", _quant("int8"), decode=KV8)
    return PRESETS[name]


@contextlib.contextmanager
def plain_kernels():
    """While open, every kernel wrapper the model calls is replaced by its
    plain PyTorch version, on the card too: the whole-model f32 reference of
    a full-width preset (TF32 off) runs on the card instead of the CPU. A
    CPU tensor meets the plain version either way."""
    from openai_whisper_compression_tpu_torch.audio import features, mel_kernel
    from openai_whisper_compression_tpu_torch.models import decode, whisper
    from openai_whisper_compression_tpu_torch.ops import attention as att
    from openai_whisper_compression_tpu_torch.ops import cross_attention as ca
    from openai_whisper_compression_tpu_torch.ops import linear as lin
    from openai_whisper_compression_tpu_torch.ops import quant_matmul as qm
    from openai_whisper_compression_tpu_torch.ops import self_attention_step as sas

    def update(plain):
        return lambda q, k, v, *rest, start=None: plain(q, k, v, *rest, start)

    with patched((mel_kernel, "log_mel_cuda",
                  lambda wav, n_mels=80, dft_dtype=torch.float32:
                  features.log_mel(wav, n_mels, dft_dtype)),
                 (whisper, "encoder_attention", att.encoder_attention_ref),
                 (whisper, "transpose_quant_kv", ca.transpose_quant_kv_ref),
                 (whisper, "decode_cross_attention_grouped",
                  ca.decode_cross_attention_grouped_ref),
                 (whisper, "decode_cross_attention", ca.decode_cross_attention_ref),
                 (lin, "int8_matmul", qm.int8_matmul_ref),
                 (lin, "int4_matmul", qm.int4_matmul_ref),
                 (lin, "nf4_matmul", qm.nf4_matmul_ref),
                 (lin, "group_asym_matmul", qm.group_asym_matmul_ref),
                 (lin, "w8a8_matmul", qm.w8a8_matmul_ref),
                 (decode, "decode_self_attention_update",
                  update(sas.decode_self_attention_update_ref)),
                 (decode, "decode_self_attention_update_int8",
                  update(sas.decode_self_attention_update_int8_ref))):
        yield


def preset_row(name: str, batch: int, walls: list, audio_per_batch: float, params,
               arch, build_s: float) -> dict:
    """A preset row as bench.py --presets reports it: rtfx (audio over the
    mean steady wall), ms_per_batch, params_mb (`size_in_mb`), the seconds
    to build and transform the tree, and `model_gflops`."""
    from openai_whisper_compression_tpu_torch.models.params import size_in_mb
    from openai_whisper_compression_tpu_torch.prune.flops import model_gflops

    wall = sum(walls) / len(walls)
    row = {"rtfx": audio_per_batch / wall, "ms_per_batch": 1e3 * wall, "batch": batch,
           "model": arch.name, "params_mb": size_in_mb(params), "build_s": build_s,
           "gflops": model_gflops(params, arch)}
    log(f"phase7 preset {name}: rtfx {row['rtfx']:.2f} ({audio_per_batch:.2f} s of audio a "
        f"batch over {wall:.4f} s), ms_per_batch {row['ms_per_batch']:.1f}, batch {batch}, "
        f"params_mb {row['params_mb']:.1f}, build and transform {build_s:.2f} s, "
        f"model_gflops {json.dumps({k: round(v, 2) for k, v in row['gflops'].items()})}")
    return row


@torch.inference_mode()
def phase7_timed(dev, summaries: dict) -> dict:
    """Phase 7's timed part, before phase 6 (no CPU work beside it): each
    P7_RUNS preset built (seeded, in its dtype, transformed; int8 trees with
    fused decoder qkv, as bench.py builds them), a cold and two steady
    batches timed (tiny and the bench rows through `make_transcribe_fn`
    with the bf16 DFT mel and tanh GELU, 25 tokens, EOT suppressed; the f16
    long-form preset through the package's `transcribe` over 240 s at
    batch_size 8, beam 5), exact launch counts from the tree's layers;
    bench.py's small_int8 and medium_int4_kv8 rows from phase 2's int8-kv
    and medium-int4 runs. The CPU f32 references of tiny and the f16 preset
    are queued (`later`). Returns the state `phase7_held` needs."""
    from openai_whisper_compression_tpu_torch import transcribe
    from openai_whisper_compression_tpu_torch.config import DecodeConfig
    from openai_whisper_compression_tpu_torch.evaluation.harness import make_transcribe_fn
    from openai_whisper_compression_tpu_torch.evaluation.tokenizer import default_tokenizer
    from openai_whisper_compression_tpu_torch.models.fuse import fuse_qkv

    rows = {}
    for row, run in (("small_int8", "int8-kv"), ("medium_int4_kv8", "medium-int4")):
        s = summaries[run]
        rows[row] = {"rtfx": s["batch"] * PRESET_UTT_S / (1e-3 * s["ms_per_batch"]),
                     "ms_per_batch": s["ms_per_batch"], "batch": s["batch"],
                     "params_mb": s["weights_mib"], "build_s": s["build_s"],
                     "gflops": s["gflops"], "from": f"phase 2 {run}"}
        log(f"phase7 preset {row} (phase 2's {run} run): rtfx {rows[row]['rtfx']:.2f}, "
            f"ms_per_batch {s['ms_per_batch']:.1f}, batch {s['batch']}, params_mb "
            f"{s['weights_mib']:.1f}, build and transform {s['build_s']:.2f} s, model_gflops "
            f"{json.dumps({k: round(v, 2) for k, v in s['gflops'].items()})}")
    state = {"rows": rows, "runs": {}}
    for name, preset_name, model, batch, switches, path in P7_RUNS:
        t0 = time.perf_counter()
        params, arch, _ = preset_of(preset_name).build(seed=SEED, device=dev)
        if preset_name in ("largev3_structured50_int8", "turbo_int8"):
            params = fuse_qkv(params)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        check(arch.name == model, f"{name}: built {arch.name}")
        enc_l, dec_l = len(params["encoder"]["layers"]), len(params["decoder"]["layers"])
        cfg = DecodeConfig(max_new_tokens=NEW_TOKENS, suppress_tokens=(arch.eos_token_id,),
                           **switches)
        longform = preset_name == "small_fp16_beam5_longform"
        if longform:
            wav = np.concatenate(list(waveforms(SEED + 7, LONGFORM_CLIPS)))
            tok = default_tokenizer(arch)
            fn = make_transcribe_fn(arch, cfg, device=dev)   # transcribe_long's own

            def call(w):
                return transcribe(params, arch, w, tok, cfg, batch_size=LONGFORM_CLIPS,
                                  device=dev)
            wavs = [wav] * 3
        else:
            fn = make_transcribe_fn(arch, cfg, fast_mel=True, fast_gelu=True, device=dev)

            def call(w):
                toks, lens = fn(params, w)
                return toks.cpu(), lens.cpu()    # the timing fence
            wavs = [torch.from_numpy(waveforms(SEED + i, batch)).to(dev) for i in range(3)]
        walls, outs = [], []
        counters = zero_launches()
        for w in wavs:
            t1 = time.perf_counter()
            outs.append(call(w))
            walls.append(time.perf_counter() - t1)
        launches = read_launches(counters)
        if longform:
            exact = {"log_mel_cuda": 3, "encoder_attention_f16": 3 * enc_l,
                     "decode_cross_attention_grouped_f16": 3 * dec_l,
                     "decode_cross_attention_grouped_f16_wide": 3 * dec_l * NEW_TOKENS,
                     "decode_self_attention_update_f16": 3 * dec_l * NEW_TOKENS}
            check(all(o == outs[0] for o in outs) and outs[0]["num_chunks"] == LONGFORM_CLIPS,
                  f"{name}: the three transcribe calls differ")
            audio = outs[0]["audio_seconds"]
        else:
            exact = expected_launches(arch, path, [NEW_TOKENS] * 3, layers=(enc_l, dec_l))
            exact["log_mel_cuda"] = 3
            if "int8_matmul" in path:   # 6 decoder linears a layer: the prefill and each step
                exact["int8_matmul"] = 6 * dec_l * (NEW_TOKENS + 1) * 3
            for toks, lens in outs:
                check(toks.shape[0] == batch and bool((lens == 4 + NEW_TOKENS).all())
                      and int(toks.max()) < arch.vocab_size,
                      f"{name}: tokens {tuple(toks.shape)} or lengths {lens.tolist()}")
            audio = batch * PRESET_UTT_S
        log(f"phase7 {name}: {arch.name} ({enc_l} encoder and {dec_l} decoder layers, "
            f"{arch.num_mel_bins} mels), {preset_name}, batch {batch}, "
            f"{json.dumps(switches)}: walls {[round(x, 4) for x in walls]} s; launches "
            f"{json.dumps(launched(launches))}")
        check_launches(name, launches, path, exact)
        rows[name] = preset_row(name, batch, walls[1:], audio, params, arch, build_s)
        state["runs"][name] = {"params": params, "arch": arch, "cfg": cfg, "wav": wavs[0],
                               "out": outs[0], "fn": fn, "path": path, "exact": exact}
        if preset_name == "tiny_fp32_greedy":
            queue_tiny_reference(name, params, arch, cfg, wavs[0], outs[0][0])
        if longform:
            queue_f16_reference(name, params, arch, cfg, wavs[0])
    return state


def queue_tiny_reference(name, params, arch, cfg, wav, tokens) -> None:
    """Queue (`later`) the tiny f32 tree's CPU f32 decode of the first
    REF_ROWS rows (same frontend and GELU): the card's tokens equal or
    parted at a proven tie."""
    from openai_whisper_compression_tpu_torch.models import decode
    from openai_whisper_compression_tpu_torch.models.params import tree_to

    params_cpu = tree_to(params, "cpu", torch.float32)
    wav, got = wav[:REF_ROWS].cpu(), tokens[:REF_ROWS].cpu()

    def proof():
        encs = {}
        enc = cpu_enc(params_cpu, arch, wav)
        ref, _ = decode.greedy_decode(params_cpu, arch, enc, cfg)
        for r in range(REF_ROWS):
            encs[r] = enc[r: r + 1]
        parted = check_ties(f"phase7 {name} card f32 vs CPU f32", params_cpu, arch, cfg,
                            wav, got, ref, 4, encs=encs)
        log(f"phase7 {name}: {REF_ROWS - parted} of {REF_ROWS} rows equal the CPU f32 "
            f"decode, {parted} part at a proven tie")
    later(f"phase7 {name}", proof)


def queue_f16_reference(name, params, arch, cfg, wav) -> None:
    """Queue (`later`) the f16 long-form preset's first-step logits of its
    first two chunks (the f32 DFT mel of `transcribe`'s path, beam 5) on the
    card in f16 against the CPU in f32, within TREE_LOGITS_REL_L2."""
    from openai_whisper_compression_tpu_torch.audio.features import preprocess
    from openai_whisper_compression_tpu_torch.evaluation.harness import samples_for_arch
    from openai_whisper_compression_tpu_torch.models.decode import first_step_logits
    from openai_whisper_compression_tpu_torch.models.params import tree_to
    from openai_whisper_compression_tpu_torch.models.whisper import encode

    n = samples_for_arch(arch)
    clips = torch.from_numpy(np.stack([wav[:n], wav[n: 2 * n]]))

    def logits(p, dtype):
        mel = preprocess(clips.to(p["encoder"]["ln"]["g"].device), arch.num_mel_bins,
                         length=n)
        return first_step_logits(p, arch, encode(p, arch, mel.to(dtype)), cfg).float().cpu()

    with torch.inference_mode():
        card = logits(params, torch.float16)
    params_cpu = tree_to(params, "cpu", torch.float32)

    def compare():
        ref = logits(params_cpu, torch.float32)
        rel = float((card - ref).norm() / ref.norm())
        log(f"phase7 {name} first-step logits card f16 vs CPU f32 (2 chunks, beam 5): "
            f"relative L2 {rel:.4g} (bound {TREE_LOGITS_REL_L2['fp16']})")
        check(bool(torch.isfinite(card).all()) and card.shape == (2 * 5, arch.vocab_size)
              and rel <= TREE_LOGITS_REL_L2["fp16"],
              f"{name}: card logits {tuple(card.shape)} off by {rel:.4g} relative L2")
    later(f"phase7 {name}", compare)


def find_key(shapes: dict, pattern: tuple, calls: dict, base: str):
    """The recorded shape key that matches `pattern` (None matching any
    value) and at which `base` launched: exactly one must."""
    keys = [k for k in {**calls, **shapes} if isinstance(k, tuple) and len(k) == len(pattern)
            and all(p is None or p == v for p, v in zip(pattern, k))
            and calls.get(k, {}).get(base, 0) > 0]
    check(len(keys) == 1, f"shape keys matching {pattern} that launched {base}: {keys}")
    return keys[0]


@torch.inference_mode()
def phase7_held(dev, state: dict, results: dict) -> dict:
    """Phase 7's held part, run inside phase 6 beside the queued CPU proofs
    (no pass of it is timed): each P7_RUNS run again with every kernel call
    held against its plain version (`checked_kernel_calls(mel=True)`),
    outputs equal to the timed run's, launch counts exact; for largev3 and
    turbo the first REF_ROWS rows recomputed in f32 on the card through the
    plain versions (TF32 off), tokens equal or parted at a tie proven in
    that recompute; tiny's `transcribe(timestamps=True)` over a seeded 60 s
    stream (the f32-DFT log-mel at batch 1, held to the float64 bound);
    `model_agreement` at AGREE_CLIPS clips for largev3_structured50_int8
    and medium_int4_kv8 against their uncompressed bf16 trees of the same
    seed; then the P7_ENTRIES shapes timed. Returns the rows."""
    from openai_whisper_compression_tpu_torch import transcribe
    from openai_whisper_compression_tpu_torch.evaluation.tokenizer import default_tokenizer

    recorded = {}
    for name, preset_name, _, batch, _, path in P7_RUNS:
        run = state["runs"][name]
        params, arch, cfg, wav = run["params"], run["arch"], run["cfg"], run["wav"]
        shapes, calls = {}, {}
        with checked_kernel_calls(shapes, calls, mel=True) as held:
            counters = zero_launches()
            t0 = time.perf_counter()
            if preset_name == "small_fp16_beam5_longform":
                out = transcribe(params, arch, wav, default_tokenizer(arch), cfg,
                                 batch_size=LONGFORM_CLIPS, device=dev)
            else:
                out = tuple(x.cpu() for x in run["fn"](params, wav))
            wall = time.perf_counter() - t0
            launches = read_launches(counters)
        exact = {k: v // 3 for k, v in run["exact"].items()}
        check_launches(f"{name} held", launches, path, exact)
        same = (out == run["out"] if isinstance(out, dict)
                else all(torch.equal(a, b) for a, b in zip(out, run["out"])))
        check(same, f"{name}: the held run's output differs from the timed run's")
        log(f"phase7 {name} held: wall {wall:.2f} s, output equal to the timed run's; "
            f"{held_summary(held, shapes)}")
        recorded[name] = (shapes, calls)
        if preset_name == "small_fp16_beam5_longform":
            from openai_whisper_compression_tpu_torch.evaluation import longform
            from openai_whisper_compression_tpu_torch.evaluation.harness import (
                samples_for_arch)

            tok, n = default_tokenizer(arch), samples_for_arch(arch)
            chunks, texts = longform.chunk_waveform(wav, n), []
            for i in range(0, len(chunks), LONGFORM_CLIPS):   # transcribe_long's batches
                buf = np.zeros((LONGFORM_CLIPS, n), np.float32)
                for j, c in enumerate(chunks[i: i + LONGFORM_CLIPS]):
                    buf[j, : len(c)] = c
                tokens, lengths = (x.cpu() for x in run["fn"](params, torch.from_numpy(buf)))
                texts += [tok.decode(tokens[j, : lengths[j]].tolist())
                          for j in range(len(chunks[i: i + LONGFORM_CLIPS]))]
            check(out["chunks"] == texts, f"{name}: chunk texts differ from the direct call's")
            log(f"phase7 {name}: {len(texts)} chunk texts equal the direct "
                "make_transcribe_fn call's")
        if preset_name in ("largev3_structured50_int8", "turbo_int8"):
            card_f32_reference(name, params, arch, cfg, wav, out[0])
        if preset_name == "tiny_fp32_greedy":
            recorded[name + " ts"] = tiny_timestamps(dev, name, params, arch)
    for preset_name in ("largev3_structured50_int8", "medium_int4_kv8"):
        agreement_at_scale(dev, preset_name)
    for entry, base, run, prefix in P7_ENTRIES:
        shapes, calls = recorded[run]
        key = find_key(shapes, prefix, calls, base)
        count = calls[key].get(base, 0)
        check(count > 0, f"phase7: {run} never launched {base} at the {key} shape")
        what = f"{run} {entry}"
        if key[0] == "log_mel_cuda":    # seeded clips at that batch, the run's DFT and mels
            res = check_mel(dev, torch.Generator(device=dev).manual_seed(SEED), key[1],
                            torch.float32 if "f32" in entry else torch.bfloat16,
                            n_mels=128 if run in ("largev3_s50_int8_ckv4", "turbo_int8")
                            else 80)
        else:
            res = time_p5_shape(what, key, shapes[key], phase="phase7")
        results[entry] = {**res, "launches": count}
    return state["rows"]


@torch.inference_mode()
def card_f32_reference(name: str, params, arch, cfg, wav, tokens,
                       phase: str = "phase7") -> None:
    """The first REF_ROWS rows of a full-width preset recomputed in f32 on
    the card through the plain versions (TF32 off: `main` sets it), with the
    same frontend (bf16 DFT) and GELU: the card's bf16 tokens equal, or
    parted at a tie proven in that f32 recompute. No kernel launches."""
    from openai_whisper_compression_tpu_torch.models import decode
    from openai_whisper_compression_tpu_torch.models.params import tree_to

    dev = wav.device
    t0 = time.perf_counter()
    params32 = tree_to(params, dev, torch.float32)
    counters = zero_launches()
    with plain_kernels():
        enc = cpu_enc(params32, arch, wav[:REF_ROWS], device=dev)
        ref, _ = decode.greedy_decode(params32, arch, enc, cfg)
        encs = {r: enc[r: r + 1] for r in range(REF_ROWS)}
        parted = check_ties(f"{phase} {name} card bf16 vs card f32", params32, arch, cfg,
                            wav[:REF_ROWS], tokens[:REF_ROWS], ref.cpu(), 4, encs=encs,
                            device=dev)
    launches = read_launches(counters)
    check(not any(launches.values()), f"{name}: the f32 reference launched "
          f"{launched(launches)}")
    log(f"{phase} {name}: {REF_ROWS - parted} of {REF_ROWS} rows equal the card f32 "
        f"recompute through the plain versions, {parted} part at a tie proven there "
        f"({time.perf_counter() - t0:.1f} s, no kernel launched)")
    del params32
    torch.cuda.empty_cache()


@torch.inference_mode()
def tiny_timestamps(dev, name: str, params, arch) -> tuple:
    """tiny_fp32_greedy's `transcribe(timestamps=True)` over one seeded 60 s
    stream: one window at a time, so the f32-DFT log-mel runs at batch 1,
    every call held (the log-mel no further than the plain version +
    MEL_EXACT_MARGIN from the float64 log-mel); a log-mel launch a window."""
    from openai_whisper_compression_tpu_torch import transcribe
    from openai_whisper_compression_tpu_torch.config import DecodeConfig

    wav = np.random.default_rng(11).standard_normal(int(PRESET_TS_S * 16000)).astype(
        np.float32) * 0.1
    shapes, calls = {}, {}
    with checked_kernel_calls(shapes, calls, mel=True) as held:
        counters = zero_launches()
        res = transcribe(params, arch, wav, decode_cfg=DecodeConfig(max_new_tokens=NEW_TOKENS),
                         timestamps=True, device=dev)
        launches = read_launches(counters)
    windows = res.get("num_windows", len(calls))
    check(isinstance(res["text"], str) and isinstance(res["segments"], list)
          and launches["log_mel_cuda"] == windows >= 2
          and launches["decode_self_attention_update_f32"] > 0,
          f"{name} timestamps: {windows} windows, launches {launched(launches)}")
    log(f"phase7 {name} transcribe(timestamps=True) over {PRESET_TS_S:.0f} s: {windows} "
        f"windows, {len(res['segments'])} segments; every log-mel at batch 1 (f32 DFT) "
        f"held to the float64 bound; {held_summary(held, shapes)}; launches "
        f"{json.dumps(launched(launches))}")
    return shapes, calls


@torch.inference_mode()
def agreement_at_scale(dev, preset_name: str) -> None:
    """`model_agreement` at AGREE_CLIPS seeded clips: the preset's tree
    (fused qkv, its decode switches on the compressed side) against the
    uncompressed bf16 tree of the same seed. Seeded weights: the numbers
    show that the harness runs at scale, not how accurate the preset is."""
    from openai_whisper_compression_tpu_torch.audio.features import preprocess
    from openai_whisper_compression_tpu_torch.config import DecodeConfig
    from openai_whisper_compression_tpu_torch.evaluation.agreement import model_agreement
    from openai_whisper_compression_tpu_torch.evaluation.harness import samples_for_arch
    from openai_whisper_compression_tpu_torch.models.fuse import fuse_qkv
    from openai_whisper_compression_tpu_torch.models.params import init_params

    t0 = time.perf_counter()
    preset = preset_of(preset_name)
    comp, arch, pcfg = preset.build(seed=SEED, device=dev)
    comp = fuse_qkv(comp)
    base = init_params(arch, SEED, torch.bfloat16, device=dev)
    wav = torch.from_numpy(waveforms(SEED + 9, AGREE_CLIPS)).to(dev)
    mels = preprocess(wav, arch.num_mel_bins, length=samples_for_arch(arch),
                      dft_dtype=torch.bfloat16).bfloat16()
    cfg = DecodeConfig(max_new_tokens=16, suppress_tokens=(arch.eos_token_id,))
    res = model_agreement(base, comp, arch, mels, cfg,
                          comp_cfg=dataclasses.replace(cfg, **preset.decode))
    check(all(np.isfinite(v) for v in res.values()) and 0 <= res["token_agreement"] <= 1,
          f"{preset_name} agreement: {res}")
    log(f"phase7 agreement {preset_name} vs its bf16 tree ({AGREE_CLIPS} clips, 16 tokens, "
        f"seeded weights: shows the harness at scale, not the preset's accuracy): "
        f"token_agreement {res['token_agreement']:.4f}, top1_agreement "
        f"{res['top1_agreement']:.4f}, mean_kl {res['mean_kl']:.4g}, logit_rel_err "
        f"{res['logit_rel_err']:.4g} ({time.perf_counter() - t0:.1f} s)")
    del comp, base
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 8 (slice 15): data-aware quantization, distillation, QAT and
# sensitivity on the card
# ---------------------------------------------------------------------------

P8_BATCH = 32                # one held batch of each run
P8_W8A8_BATCH = 96           # smooth-w8a8-small: the small-w8a8-dyn run's batch
P8_CLIPS = 4                 # make_calibration_fn's seeded 30 s clips
P8_KEEP = 0.3                # activation_guided_ffn_prune: 3072 -> 922 units
P8_QAT_STEPS = 3
P8_PROOF_LAYERS = 2          # the card-vs-CPU f32 proofs' depth (full width)
# gptq-small's depth (full width): its solve, a host loop over K rows, took
# 42.5-52.3 s at 12 layers on an H100 80GB HBM3 at 700 W; three quarters of
# that time went to phase 9 (slice 16)
P8_GPTQ_LAYERS = 3
# - the CPU f32 proofs of phase 8 (f32 on both sides, TF32 off; sums in
#   other orders through 2 layers and the backward): the QAT loss within
#   1e-4 relative or 1e-5 absolute (the KL of a student that is its teacher
#   but for int4 rounding is small, ~1e-3, and the logits' f32 sum-order
#   noise, ~1e-5 at logits of order 1-10, moves it by ~(p - q)·dz, a few
#   1e-6), its gradient and the Fisher scores within 1e-3 relative (each
#   leaf's L2 for the gradient); AWQ's alphas equal or a tie within 1e-6
#   relative. The card's GPTQ row loop equals the CPU's bit for bit on the
#   same factor (`run_gptq`).
P8_LOSS_REL, P8_LOSS_ABS, P8_GRAD_REL, P8_FISHER_REL, P8_TIE_REL = (
    1e-4, 1e-5, 1e-3, 1e-3, 1e-6)
# kernels-line entries for the ragged w8a8 shapes only phase 8 gives the
# kernel (whisper-small's FFN of 922 units after activation_guided_ffn_prune):
# (entry name, KERNELS entry, phase-8 run, `checked_kernel_calls` key)
P8_ENTRIES = [
    (f"w8a8_matmul@ffn922-fc1-M{P8_BATCH}", "w8a8_matmul", "prune-w8a8-small",
     ("w8a8_matmul", P8_BATCH, 768, 922, False)),
    (f"w8a8_matmul@ffn922-fc2-M{P8_BATCH}", "w8a8_matmul", "prune-w8a8-small",
     ("w8a8_matmul", P8_BATCH, 922, 768, False)),
    (f"w8a8_matmul@ffn922-fc1-M{P8_BATCH * 1500}", "w8a8_matmul", "prune-w8a8-small",
     ("w8a8_matmul", P8_BATCH * 1500, 768, 922, False)),
    (f"w8a8_matmul@ffn922-fc2-M{P8_BATCH * 1500}", "w8a8_matmul", "prune-w8a8-small",
     ("w8a8_matmul", P8_BATCH * 1500, 922, 768, False)),
]
_MATMUL_OF_KIND = {"int8_pc": "int8_matmul", "int4_pack": "int4_matmul",
                   "nf4": "nf4_matmul", "fp4": "nf4_matmul"}


def p8_clips(arch):
    """The calibration set: P8_CLIPS seeded 30 s clips (`waveforms`) as
    utterances with seeded reference texts."""
    from openai_whisper_compression_tpu_torch.evaluation.data import Utterance

    wav = waveforms(SEED + 80, P8_CLIPS)
    words = ["the", "quick", "brown", "fox", "jumps", "over", "a", "lazy", "dog"]
    return [Utterance(audio=w, text=" ".join(words[i:] + words[:i]), duration=AUDIO_S,
                      uid=f"p8-{i}") for i, w in enumerate(wav)]


def cut_layers(params, arch, n: int):
    """The first `n` encoder and decoder layers of a tree (leaves shared),
    with its arch: the full-width, shallow tree of the CPU f32 proofs."""
    from openai_whisper_compression_tpu_torch.models.params import copy_tree

    out = copy_tree(params)
    for comp in ("encoder", "decoder"):
        out[comp]["layers"] = out[comp]["layers"][:n]
    return out, arch.replace(encoder_layers=n, decoder_layers=n)


def p8_exact(arch, params, batch: int, path) -> dict:
    """Exact launches of one batch through `make_transcribe_fn` with int8
    caches, 25 tokens: `expected_launches` for the attention kernels and the
    w8a8 matmul, the mel once, the cross-KV quantizer for K and V of each
    decoder layer, and each weight-only kernel once for each decoder linear
    of its kind at the prefill and every step (the cross K and V and every
    encoder linear run at encoder M, above the kernels' threshold)."""
    exact = expected_launches(arch, path, [NEW_TOKENS])
    exact.update({"log_mel_cuda": 1, "transpose_quant_kv": 2 * arch.decoder_layers})
    if "transpose_quant_kv_wide_dh" in path:   # every launch a WIDE body's
        exact["transpose_quant_kv_wide_dh"] = exact["transpose_quant_kv"]
    for k in decoder_matmuls(params):
        exact[k] = exact.get(k, 0) + NEW_TOKENS + 1
    return exact


def p8_decode(dev, name: str, arch, params, batch: int, path, seed: int) -> dict:
    """One held batch (`checked_kernel_calls(mel=True)`): seeded
    30 s clips through `make_transcribe_fn` (bf16 DFT mel, tanh GELU, int8
    self-KV and cross-KV, greedy 25 tokens, EOT suppressed), every kernel
    call held against its plain version, launch counts exact, no activation
    record made (`capture.record` is never called outside a capture); then
    the first REF_ROWS rows recomputed in f32 on the card through the plain
    versions, tokens equal or parted at a proven tie."""
    from openai_whisper_compression_tpu_torch.config import DecodeConfig
    from openai_whisper_compression_tpu_torch.evaluation.harness import make_transcribe_fn
    from openai_whisper_compression_tpu_torch.utils import capture

    cfg = DecodeConfig(max_new_tokens=NEW_TOKENS, suppress_tokens=(arch.eos_token_id,), **KV8)
    fn = make_transcribe_fn(arch, cfg, fast_mel=True, fast_gelu=True, device=dev)
    wav = torch.from_numpy(waveforms(seed, batch)).to(dev)
    records = []
    shapes: dict = {}
    calls: dict = {}
    t0 = time.perf_counter()
    with patched((capture, "record", lambda *a: records.append(a[0]))), \
            checked_kernel_calls(shapes, calls, mel=True) as held:
        counters = zero_launches()
        with torch.inference_mode():
            toks, lens = fn(params, wav)
        toks, lens = toks.cpu(), lens.cpu()
        launches = read_launches(counters)
    secs = time.perf_counter() - t0
    check(not records, f"{name}: a decode made activation records {records[:3]}")
    check(toks.shape[0] == batch and bool((lens == 4 + NEW_TOKENS).all())
          and int(toks.max()) < arch.vocab_size,
          f"{name}: tokens {tuple(toks.shape)} or lengths {lens.tolist()}")
    exact = p8_exact(arch, params, batch, path)
    log(f"phase8 {name}: held batch of {batch} in {secs:.2f} s; launches "
        f"{json.dumps(launched(launches))}; {held_summary(held, shapes)}")
    check_launches(name, launches, path, exact)
    card_f32_reference(name, params, arch, cfg, wav, toks, phase="phase8")
    return {"launches": launches, "shapes": shapes, "calls": calls, "held_s": secs}


def gptq_objective(w, q, h) -> float:
    """tr((W - Ŵ)^T H (W - Ŵ)) of an int4 or int8 QTensor `q` of w, in f32."""
    from openai_whisper_compression_tpu_torch.ops.qtensor import dequantize

    e = w.float() - dequantize(q, torch.float32)
    return float(torch.einsum("ij,ik,kj->", e, h, e))


def run_gptq(dev, arch, run_cal) -> dict:
    """gptq-small: `quantize_data_aware("gptq_int4")` on the card over the
    first P8_GPTQ_LAYERS encoder and decoder layers at full width (Hessians
    from `make_calibration_fn`'s pass, the solve of 48 weights), timed in
    its two parts; the median over the weights of the GPTQ / round-to-
    nearest objective under each Hessian must be <= 1. The card's solve of
    encoder layer 0's fc2 (K = 3072) is held against the CPU's (queued): the
    row loop bit for bit on the card's factor, the factors' difference and
    the codes over each reported, both below round-to-nearest."""
    from openai_whisper_compression_tpu_torch.models.fuse import fuse_qkv
    from openai_whisper_compression_tpu_torch.models.params import init_params, named_leaves
    from openai_whisper_compression_tpu_torch.quant import gptq
    from openai_whisper_compression_tpu_torch.quant.api import quantize_data_aware
    from openai_whisper_compression_tpu_torch.ops.qtensor import QTensor, pack_int_sub8
    from openai_whisper_compression_tpu_torch.quant.core import quantize_int_sub8

    params, arch = cut_layers(init_params(arch, seed=SEED, dtype=torch.bfloat16, device=dev),
                              arch, P8_GPTQ_LAYERS)
    kept, t = {}, {}
    real = gptq.collect_hessians

    def timed_hessians(*a, **kw):
        t0 = time.perf_counter()
        kept.update(real(*a, **kw))
        torch.cuda.synchronize()
        t["hessians_s"] = time.perf_counter() - t0
        t["solve_from"] = time.perf_counter()
        return kept

    t0 = time.perf_counter()
    with patched((gptq, "collect_hessians", timed_hessians)):
        q = quantize_data_aware(params, arch, "gptq_int4", run_cal)
    torch.cuda.synchronize()
    t["solve_s"] = time.perf_counter() - t.pop("solve_from")
    total = time.perf_counter() - t0
    leaves = dict(named_leaves(params))
    ratios = []
    for name, leaf in named_leaves(q):
        if name in kept:
            h = kept[name]
            check(leaf.kind == "int4_pack", f"gptq-small: {name} is {leaf.kind}")
            ratios.append(gptq_objective(leaves[name], leaf, h)
                          / gptq_objective(leaves[name], quantize_int_sub8(leaves[name], 4), h))
    med = float(np.median(ratios))
    log(f"phase8 gptq-small: {len(kept)} Hessians in {t['hessians_s']:.2f} s, {len(ratios)} "
        f"solves in {t['solve_s']:.2f} s ({total:.2f} s in all); GPTQ / RTN objective median "
        f"{med:.4f}, min {min(ratios):.4f}, max {max(ratios):.4f}")
    check(len(ratios) == 6 * arch.encoder_layers + 10 * arch.decoder_layers and med <= 1.0,
          f"gptq-small: {len(ratios)} weights, objective ratio median {med}")
    name = "encoder.layers.0.fc2.w"
    w, h = leaves[name].float(), kept[name]
    qc, sc, _ = gptq.gptq_solve(w, h, bits=4)
    uc, _ = gptq._factor(h, 0.01)
    w_cpu, h_cpu, u_cpu = w.cpu(), h.cpu(), uc.cpu()
    qc, sc = qc.cpu(), sc.cpu()

    def proof():
        # the row loop is plain IEEE arithmetic: the CPU's on the card's
        # factor gives the card's codes bit for bit; the factor itself
        # (an f32 inverse of an ill-conditioned matrix) is LAPACK's or
        # cuSOLVER's, and codes solved over either are GPTQ solutions of the
        # same problem, each below round-to-nearest's objective
        same = gptq._quantize_rows(w_cpu, sc, u_cpu, 7)
        qp, sp, okp = gptq.gptq_solve(w_cpu, h_cpu, bits=4)
        up, _ = gptq._factor(h_cpu, 0.01)
        diff = (qc.int() - qp.int()).abs()
        rtn = quantize_int_sub8(w_cpu, 4)
        objs = [gptq_objective(w_cpu, QTensor(data=pack_int_sub8(q.int(), 4), scale=s,
                                               kind="int4_pack", bits=4, shape=tuple(w.shape)),
                               h_cpu) for q, s in ((qc, sc), (qp, sp))]
        o_rtn = gptq_objective(w_cpu, rtn, h_cpu)
        log(f"phase8 gptq-small {name}: the CPU's row loop on the card's factor gives the "
            f"card's codes {'bit for bit' if torch.equal(same, qc) else 'NOT'}; the f32 "
            f"factors differ by {float((u_cpu - up).norm() / up.norm()):.3g} relative, "
            f"and {int((diff > 0).sum())} of {diff.numel()} codes solved over them (most "
            f"{int(diff.max())}); objective card {objs[0]:.6g}, CPU {objs[1]:.6g}, RTN {o_rtn:.6g}")
        check(torch.equal(same, qc) and torch.equal(sc, sp) and bool(okp)
              and max(objs) < o_rtn, f"gptq-small: the card's solve of {name} is not the CPU's")
    later("phase8 gptq-small", proof)
    return {"params": fuse_qkv(q), "arch": arch, "quantize_s": total, **t,
            "objective_median": med}


def run_awq(dev, arch, run_cal) -> dict:
    """awq-nf4-small: AWQ's statistics and alpha search on the card, NF4
    weights; the search of the first P8_PROOF_LAYERS layers' sites on the
    CPU on the same statistics and weights (queued): alphas equal, or the
    two candidates' errors a tie."""
    from openai_whisper_compression_tpu_torch.models.fuse import fuse_qkv
    from openai_whisper_compression_tpu_torch.models.params import init_params, tree_to
    from openai_whisper_compression_tpu_torch.quant import smooth
    from openai_whisper_compression_tpu_torch.quant.api import quantize_params

    params = init_params(arch, seed=SEED, dtype=torch.bfloat16, device=dev)
    t0 = time.perf_counter()
    stats = smooth.collect_ln_stats(params, arch, run_cal)
    t_stats = time.perf_counter() - t0
    smoothed, alphas = smooth.awq_search(params, arch, stats=stats, method="nf4")
    q = quantize_params(smoothed, "nf4")
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    log(f"phase8 awq-nf4-small: statistics of {len(stats)} sites in {t_stats:.2f} s, search "
        f"and NF4 in {total - t_stats:.2f} s; alphas {json.dumps(alphas)}")
    cut, arch2 = cut_layers(params, arch, P8_PROOF_LAYERS)
    cut = tree_to(cut, "cpu", torch.bfloat16)
    keys = smooth._site_keys(P8_PROOF_LAYERS, P8_PROOF_LAYERS)

    def proof():
        _, cpu_alphas = smooth.awq_search(cut, arch2, stats={k: stats[k] for k in keys},
                                          method="nf4")
        ties = 0
        for key in keys:
            if cpu_alphas[key] != alphas[key]:
                quantizer = smooth._resolve_quantizer("nf4")
                site = next(s for s in smooth._sites(cut) if s[0] == key)
                ws = [c["w"].float() for c in site[2]]
                x = torch.from_numpy(stats[key]["rows"])
                ax = np.maximum(stats[key]["amax"], 1e-8)
                errs = []
                for a in (alphas[key], cpu_alphas[key]):
                    s = ax ** a
                    s = smooth._safe_scale(s / np.exp(np.mean(np.log(np.maximum(s, 1e-8)))))
                    errs.append(smooth._site_quant_error(x, ws, [x @ w for w in ws], s,
                                                         quantizer))
                log(f"phase8 awq-nf4-small {key}: card alpha {alphas[key]} vs CPU "
                    f"{cpu_alphas[key]}, CPU errors {errs}")
                check(abs(errs[0] - errs[1]) <= P8_TIE_REL * max(errs),
                      f"awq-nf4-small {key}: alphas differ and are no tie")
                ties += 1
        log(f"phase8 awq-nf4-small: the first {len(keys)} sites' alphas on the CPU equal the "
            f"card's at {len(keys) - ties}, a tie at {ties}")
    later("phase8 awq-nf4-small", proof)
    return {"params": fuse_qkv(q), "quantize_s": total}


def run_smooth_w8a8(dev, arch, run_cal, prune: bool) -> dict:
    """smooth-w8a8-small: `quantize_data_aware("smoothquant_w8a8")`, w8a8 at
    every linear. prune-w8a8-small: `activation_guided_ffn_prune(0.3)` first
    (FFN 3072 -> 922 units: the ragged w8a8 kernel at decode and encoder M)."""
    from openai_whisper_compression_tpu_torch.models.fuse import fuse_qkv
    from openai_whisper_compression_tpu_torch.models.params import init_params
    from openai_whisper_compression_tpu_torch.quant.api import quantize_data_aware
    from openai_whisper_compression_tpu_torch.sensitivity.activation import (
        activation_guided_ffn_prune)
    from openai_whisper_compression_tpu_torch.sensitivity.gradient import (
        make_synthetic_batches)

    params = init_params(arch, seed=SEED, dtype=torch.bfloat16, device=dev)
    t0 = time.perf_counter()
    if prune:
        batches = make_synthetic_batches(arch, n_batches=1, batch=2, seq=8, seed=SEED)
        params = activation_guided_ffn_prune(params, arch, batches, keep_fraction=P8_KEEP)
        ffn = params["encoder"]["layers"][0]["fc1"]["w"].shape[1]
        check(ffn == round(P8_KEEP * arch.ffn_dim), f"prune-w8a8-small: FFN {ffn}")
    q = quantize_data_aware(params, arch, "smoothquant_w8a8", run_cal)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    ffn = params["encoder"]["layers"][0]["fc1"]["w"].shape[1]
    log(f"phase8 {'prune' if prune else 'smooth'}-w8a8-small: "
        f"{f'activation-guided FFN prune to {ffn} units, ' if prune else ''}SmoothQuant "
        f"statistics, fold and w8a8 in {total:.2f} s")
    return {"params": fuse_qkv(q), "quantize_s": total}


def run_mixed(dev, arch) -> dict:
    """mixed-small: Fisher scores of the f32 tree on the card into
    `generate_quant_config(6.0)` over int4/int8, applied to the bf16 tree
    (int4 and int8 leaves in one tree). The scores of the first
    P8_PROOF_LAYERS layers (cut tree, full width) on the card against the
    CPU's (queued)."""
    from openai_whisper_compression_tpu_torch.models.fuse import fuse_qkv
    from openai_whisper_compression_tpu_torch.models.params import (init_params, tree_cast,
                                                                     tree_to)
    from openai_whisper_compression_tpu_torch.quant.mixed import (apply_quant_config,
                                                                  generate_quant_config)
    from openai_whisper_compression_tpu_torch.sensitivity.gradient import (
        compute_fisher_sensitivity, make_synthetic_batches)

    params = init_params(arch, seed=SEED, dtype=torch.bfloat16, device=dev)
    batches = make_synthetic_batches(arch, n_batches=1, batch=2, seq=8, seed=SEED)
    t0 = time.perf_counter()
    scores = compute_fisher_sensitivity(tree_cast(params, torch.float32), arch, batches)
    t_fisher = time.perf_counter() - t0
    cfg = generate_quant_config(params, scores, 6.0)
    q = apply_quant_config(params, cfg)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    log(f"phase8 mixed-small: Fisher scores of {len(scores)} leaves in {t_fisher:.2f} s, "
        f"config and quantize in {total - t_fisher:.2f} s: avg_bits {cfg['avg_bits']}, "
        f"counts {json.dumps(cfg['counts'])}")
    check(cfg["avg_bits"] <= 6.0 and all(v > 0 for v in cfg["counts"].values()),
          f"mixed-small: config {cfg['avg_bits']} {cfg['counts']}")
    cut, arch2 = cut_layers(tree_cast(params, torch.float32), arch, P8_PROOF_LAYERS)
    card = compute_fisher_sensitivity(cut, arch2, batches)
    cut_cpu = tree_to(cut, "cpu", torch.float32)

    def proof():
        with torch.inference_mode(False):
            ref = compute_fisher_sensitivity(cut_cpu, arch2, batches)
        rel = {k: abs(card[k] - v) / v for k, v in ref.items() if v > 0}
        worst = max(rel, key=rel.get)
        log(f"phase8 mixed-small: {P8_PROOF_LAYERS}-layer Fisher scores card vs CPU f32 over "
            f"{len(ref)} leaves: worst relative {rel[worst]:.3g} ({worst}; bound "
            f"{P8_FISHER_REL})")
        check(set(card) == set(ref) and all(card[k] > 0 for k in rel)
              and rel[worst] <= P8_FISHER_REL, f"mixed-small: Fisher scores off at {worst}")
    later("phase8 mixed-small", proof)
    return {"params": fuse_qkv(q), "quantize_s": total, "config": cfg}


def run_qat(dev, arch) -> dict:
    """qat-small: `qat_distill(int4, steps=3, batch=2, seq_len=8,
    compute_dtype=f32)` of the seeded bf16 tree toward itself: the loss and
    seconds of each step and the peak memory. Step 0's loss and gradient of
    the first P8_PROOF_LAYERS layers (cut tree, full width) on the card,
    held against a CPU f32 recompute on the same batch and teacher logits
    (queued)."""
    from openai_whisper_compression_tpu_torch import distill
    from openai_whisper_compression_tpu_torch.evaluation.harness import samples_for_arch
    from openai_whisper_compression_tpu_torch.models.fuse import fuse_qkv
    from openai_whisper_compression_tpu_torch.models.params import (
        copy_tree, init_params, named_leaves, set_leaf, tree_to)
    from openai_whisper_compression_tpu_torch.quant.qat import make_ste_transform, qat_distill

    params = init_params(arch, seed=SEED, dtype=torch.bfloat16, device=dev)
    stamps = []
    real = distill.kl_loss

    def stamped(*a, **kw):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        return real(*a, **kw)

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with patched((distill, "kl_loss", stamped)):
        q, history = qat_distill(params, params, arch, method="int4", steps=P8_QAT_STEPS,
                                 batch=2, seq_len=8, compute_dtype=torch.float32)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    step_s = [b - a for a, b in zip(stamps, stamps[1:] + [time.perf_counter()])]
    log(f"phase8 qat-small: {P8_QAT_STEPS} steps, losses {[round(x, 6) for x in history]}, "
        f"seconds a step {[round(x, 3) for x in step_s]} (with the final int4 quantize: "
        f"{total:.2f} s in all), peak {peak:.1f} MiB")
    check(len(history) == P8_QAT_STEPS and all(np.isfinite(history)),
          f"qat-small: losses {history}")

    cut, arch2 = cut_layers(params, arch, P8_PROOF_LAYERS)
    rng = np.random.default_rng(SEED)
    mel, tokens = distill._synthetic_batch(rng, arch2, 2, 8, samples_for_arch(arch2), dev)
    with torch.no_grad():
        t_logits = distill.decode_logits(cut, arch2, tokens, distill.encode(cut, arch2, mel))

    def loss_and_grads(tree, batch):
        leaves = {n: t.detach().float().clone().requires_grad_(True)
                  for n, t in named_leaves(tree)}
        student = copy_tree(tree)
        for n, t in leaves.items():
            set_leaf(student, n, t)
        with torch.enable_grad():
            loss = distill.kl_loss(make_ste_transform(student, "int4")(student),
                                   batch[2], arch2, batch[0], batch[1])
            grads = torch.autograd.grad(loss, list(leaves.values()))
        return float(loss.detach()), {n: g.cpu() for n, g in zip(leaves, grads)}

    card_loss, card_grads = loss_and_grads(cut, (mel, tokens, t_logits))
    cut_cpu = tree_to(cut, "cpu", torch.float32)
    batch_cpu = (mel.cpu(), tokens.cpu(), t_logits.cpu())

    def proof():
        with torch.inference_mode(False):
            ref_loss, ref_grads = loss_and_grads(cut_cpu, batch_cpu)
        rel_loss = abs(card_loss - ref_loss) / abs(ref_loss)
        loss_ok = abs(card_loss - ref_loss) <= max(P8_LOSS_REL * abs(ref_loss), P8_LOSS_ABS)
        rel = {n: float((card_grads[n] - g).norm() / g.norm()) for n, g in ref_grads.items()
               if bool(g.abs().sum() > 0)}
        zero = [n for n, g in ref_grads.items() if not bool(g.abs().sum() > 0)]
        worst = max(rel, key=rel.get)
        log(f"phase8 qat-small step 0 at {P8_PROOF_LAYERS} layers: loss card {card_loss:.6g} "
            f"vs CPU f32 {ref_loss:.6g} (relative {rel_loss:.3g}, bound {P8_LOSS_REL} or "
            f"{P8_LOSS_ABS} absolute); "
            f"gradient of {len(rel)} leaves, worst relative L2 {rel[worst]:.3g} ({worst}; "
            f"bound {P8_GRAD_REL}); {len(zero)} leaves with a zero gradient on both")
        check(loss_ok and rel[worst] <= P8_GRAD_REL
              and all(not bool(card_grads[n].abs().sum() > 0) for n in zero)
              and all(bool(card_grads[n].abs().sum() > 0) for n in rel),
              f"qat-small: step 0 off (loss {rel_loss:.3g}, gradient {rel[worst]:.3g} at {worst})")
    later("phase8 qat-small", proof)
    return {"params": fuse_qkv(q), "quantize_s": total, "losses": history, "step_s": step_s,
            "peak_mib": peak}


def time_w8a8_shape(what: str, args: tuple) -> dict:
    """The w8a8 matmul at a shape phase 8 gave it (the first held call's
    inputs): bit-equal to its plain version, timed beside it, quantize +
    `torch._int_mm` + epilogue where cuBLASLt takes the widths (else no
    library time), and its bound."""
    from openai_whisper_compression_tpu_torch.ops import quant_matmul as qm

    x, w, scale, act_scale = args
    m, k = x.shape
    n = w.shape[1]
    got = qm.w8a8_matmul(x, w, scale, act_scale)
    check(torch.equal(got, qm.w8a8_matmul_ref(x, w, scale, act_scale)),
          f"{what}: differs from the plain version")
    few = {"warmup": 1, "iters": 3} if m > 1024 else {}
    t_k = cuda_ms(lambda: qm.w8a8_matmul(x, w, scale, act_scale), **few)
    t_p = cuda_ms(lambda: qm.w8a8_matmul_ref(x, w, scale, act_scale), **few)
    try:
        int_mm_library(x, w, scale, act_scale)
        t_l = cuda_ms(lambda: int_mm_library(x, w, scale, act_scale), **few)
    except RuntimeError as e:   # cuBLASLt's int8 product wants K and N in multiples
        log(f"phase8 {what}: torch._int_mm refuses M={m} K={k} N={n} ({str(e)[:80]})")
        t_l = None
    least = bound(nbytes(x, w, scale, got), 2 * m * k * n / INT8_OPS)
    log(f"phase8 {what} w8a8_matmul M={m} K={k} N={n}: equal to the plain version bit for "
        f"bit; kernel {t_k:.4f} ms plain {t_p:.4f} ms quantize+torch._int_mm+epilogue "
        f"{'n/a' if t_l is None else f'{t_l:.4f} ms'} least {least['bound_ms']:.5f} ms "
        f"({least['bound_by']})")
    return {"max_abs_err": 0.0, "ms": t_k, "plain_ms": t_p, **least, "library_ms": t_l}


def phase8(dev, results: dict) -> dict:
    """Phase 8 (slice 15): the data-aware quantizers, distillation with QAT
    and the sensitivity scorers on the card at whisper-small's full width
    and depth, seeded; each quantized tree decoded as one held batch
    (`p8_decode`). The card-vs-CPU f32 proofs run at P8_PROOF_LAYERS layers,
    queued (`later`). Returns the runs' summaries."""
    from openai_whisper_compression_tpu_torch.config import ARCHS
    from openai_whisper_compression_tpu_torch.evaluation.harness import make_calibration_fn
    from openai_whisper_compression_tpu_torch.evaluation.tokenizer import default_tokenizer

    arch = ARCHS[ARCH]
    run_cal = make_calibration_fn(arch, p8_clips(arch), default_tokenizer(arch),
                                  batch_size=P8_CLIPS, n_tokens=8, device=dev)
    mm8 = ("log_mel_cuda", "encoder_attention", "transpose_quant_kv",
           "decode_cross_attention_grouped_int8", "decode_self_attention_update_int8")
    runs = [
        ("gptq-small", lambda: run_gptq(dev, arch, run_cal), P8_BATCH, mm8 + ("int4_matmul",)),
        ("awq-nf4-small", lambda: run_awq(dev, arch, run_cal), P8_BATCH, mm8 + ("nf4_matmul",)),
        ("smooth-w8a8-small", lambda: run_smooth_w8a8(dev, arch, run_cal, False),
         P8_W8A8_BATCH, mm8 + ("w8a8_matmul",)),
        ("prune-w8a8-small", lambda: run_smooth_w8a8(dev, arch, run_cal, True), P8_BATCH,
         mm8 + ("w8a8_matmul",)),
        ("mixed-small", lambda: run_mixed(dev, arch), P8_BATCH,
         mm8 + ("int4_matmul", "int8_matmul")),
        ("qat-small", lambda: run_qat(dev, arch), P8_BATCH, mm8 + ("int4_matmul",)),
    ]
    summaries = {}
    for i, (name, build, batch, path) in enumerate(runs):
        t0 = time.perf_counter()
        built = build()
        params, run_arch = built.pop("params"), built.pop("arch", arch)
        summaries[name] = {**built, **p8_decode(dev, name, run_arch, params, batch, path,
                                                SEED + 81 + i)}
        summaries[name]["batch"] = batch
        del params
        torch.cuda.empty_cache()
        log(f"phase8 {name}: {time.perf_counter() - t0:.1f} s in all")
    calls = summaries["prune-w8a8-small"]["calls"]
    shapes = summaries["prune-w8a8-small"]["shapes"]
    for entry, _, run, key in P8_ENTRIES:
        check(key in shapes, f"{run}: the w8a8 kernel never ran at {key}")
        results[entry] = {**time_w8a8_shape(entry, shapes[key]),
                          "launches": calls[key]["w8a8_matmul"]}
    for s in summaries.values():
        del s["shapes"], s["calls"]
    return summaries


# ---------------------------------------------------------------------------
# Phase 9 (slice 16): storage formats, checkpoint conversion, the sweeps
# ---------------------------------------------------------------------------

P9_BATCH = 32
P9_PRUNE = 0.8      # storage-small's f32 tree, pruned by prune_global_l1
P9_SPARSE_AT = 0.7  # save_sparse_zip's default threshold
P9_STORE_LAYERS = 2  # storage-small's trees: their first 2 encoder and decoder layers
P9_SWEEP = ("baseline_bf16", "quanto_int8", "quanto_int4", "l1_global_50pct")
P9_INTERRUPT_AFTER = 2   # the sweep is interrupted when its third config starts
P9_UTTS = 32             # the sweep's synthetic utterances: one batch
P9_RUNGS = ("int8", "heads50+int8", "declayers-25%+int8")
P9_CURVE_ITERS = 3
# the curve's tree: the seeded bf16 tree cut to its first 4 encoder and
# decoder layers (full width; declayers-25% then keeps 3 decoder layers)
P9_CURVE_LAYERS = 4
P9_AGREE = 8             # run_curve's agreement_samples
# kernels-line entries for the shapes only phase 9 gives the kernels: (entry
# name, the KERNELS entry, the run whose held calls at that shape it counts
# and times, the `checked_kernel_calls` shape key)
P9_ENTRIES = [
    ("transpose_quant_kv@f32-small", "transpose_quant_kv", "sparse-f32",
     ("transpose_quant_kv", 1500, 768)),
    ("decode_cross_attention_grouped_int8@f32q-384rows", "decode_cross_attention_grouped_int8",
     "sparse-f32", ("grouped", "torch.int8", 1500, 1, P9_BATCH * 12)),
    ("decode_self_attention_update_int8@f32q-384rows", "decode_self_attention_update_int8",
     "sparse-f32", ("decode_self_attention_update_int8", "torch.float32", P9_BATCH * 12, 64,
                    False)),
    ("encoder_attention@small-heads50", "encoder_attention", "curve",
     ("encoder_attention", 6, 1500)),
    ("int8_matmul@heads50-q-M32", "int8_matmul", "curve", ("int8_matmul", P9_BATCH, 768, 384)),
    ("decode_cross_attention_grouped_int8@heads50-192rows", "decode_cross_attention_grouped_int8",
     "curve", ("grouped", "torch.int8", 1500, 1, P9_BATCH * 6)),
]
_SUFFIX = {torch.bfloat16: "", torch.float32: "_f32", torch.float16: "_f16"}


def recorded_paths(sink: list) -> list:
    """Patches (for `patched`) that record what a block ran, so that its
    exact launch counts follow from the record (`recorded_launches`): every
    log-mel on the card (`features.preprocess`), every encoder pass (the
    encode of `make_transcribe_fn` and of `model_agreement`), every greedy
    decode (its tree, batch, decoder steps and prefix) and every
    teacher-forced `decode_logits` of `model_agreement`."""
    from openai_whisper_compression_tpu_torch.audio import features
    from openai_whisper_compression_tpu_torch.config import DecodeConfig
    from openai_whisper_compression_tpu_torch.evaluation import agreement, harness
    from openai_whisper_compression_tpu_torch.models import decode

    def wrap(mod, name, note):
        real = getattr(mod, name)

        def fn(*a, **kw):
            out = real(*a, **kw)
            note(out, *a, **kw)
            return out
        return (mod, name, fn)

    def mel(out, wav, *a, **kw):
        if wav.is_cuda:
            sink.append(("mel",))

    def enc(out, params, arch, mel, *a, **kw):
        sink.append(("encode", params, mel.dtype, mel.shape[-1] // 2))

    def greedy(out, params, arch, enc_out, cfg=None, *a, **kw):
        cfg = cfg or DecodeConfig()
        check(kw.get("prompt_tokens") is None, "phase9: a prompted decode is not recorded")
        first_gen = len(decode.forced_prefix(arch, cfg))
        sink.append(("greedy", params, arch, cfg, enc_out.shape[0],
                     int(out[1].max()) - first_gen, first_gen, enc_out.dtype))

    def logits(out, params, arch, tokens, *a, **kw):
        sink.append(("logits", params, tokens.numel()))

    return [wrap(features, "preprocess", mel), wrap(harness, "encode", enc),
            wrap(agreement, "encode", enc), wrap(harness, "greedy_decode", greedy),
            wrap(decode, "greedy_decode", greedy), wrap(agreement, "decode_logits", logits)]


def decoder_matmuls(params) -> list:
    """The weight-only kernel of each quantized decoder linear that runs at
    decode M (every one but the cross K and V, which run at encoder M)."""
    from openai_whisper_compression_tpu_torch.models.params import named_leaves
    from openai_whisper_compression_tpu_torch.ops.qtensor import QTensor

    out = []
    for name, leaf in named_leaves(params["decoder"]):
        if (isinstance(leaf, QTensor) and leaf.act is None and name.endswith(".w")
                and not name.endswith(("cross.k.w", "cross.v.w"))):
            check(leaf.kind in _MATMUL_OF_KIND, f"no launch rule for a {leaf.kind} linear")
            out.append(_MATMUL_OF_KIND[leaf.kind])
    return out


def recorded_launches(records: list) -> dict:
    """Exact launch counts of what `recorded_paths` recorded: the mel once a
    card call; the encoder attention once an encoder layer of a pass (in the
    entry of the pass's type);
    each quantized decoder linear's kernel once a teacher-forced pass, and
    once for the prefill and every step of a greedy decode (M = rows x
    window, at most 1024); per decode, the cross-KV quantizer for K and V
    of each layer under int8 cross-KV, the grouped cross-attention a layer
    for the prefill window and a layer and step (the one-query kernel for
    the steps where B·H % 16 != 0), the cache update a layer and step."""
    from openai_whisper_compression_tpu_torch.ops.linear import kernel_m_threshold

    threshold = kernel_m_threshold()

    exact: dict = {}

    def add(k, n):
        exact[k] = exact.get(k, 0) + n

    for r in records:
        if r[0] == "mel":
            add("log_mel_cuda", 1)
        elif r[0] == "encode":
            _, params, dtype, t = r
            if t >= 256:   # the body of the pass's type
                add("encoder_attention" + _SUFFIX[dtype], len(params["encoder"]["layers"]))
        elif r[0] == "logits":
            if r[2] <= threshold:
                for k in decoder_matmuls(r[1]):
                    add(k, 1)
        else:
            _, params, arch, cfg, b, steps, first_gen, dtype = r
            layers = len(params["decoder"]["layers"])
            # the heads the weights hold (physical head pruning narrows them)
            heads = params["decoder"]["layers"][0]["cross"]["q"]["w"].shape[1] // arch.head_dim
            sfx = _SUFFIX[dtype]
            if cfg.cross_kv_int8:
                cross = "decode_cross_attention_grouped_int8"
                add("transpose_quant_kv", 2 * layers)
            else:
                cross = "decode_cross_attention_grouped" + sfx
            check(first_gen > 1 and first_gen - 1 <= 8, f"phase9: a prefix of {first_gen}")
            add(cross, layers)
            add(cross if b * heads % 16 == 0 else cross.replace("_grouped", ""), layers * steps)
            add("decode_self_attention_update_int8" if cfg.kv_int8
                else "decode_self_attention_update" + sfx, layers * steps)
            for k in decoder_matmuls(params):
                add(k, steps + (b * (first_gen - 1) <= threshold))
    return exact


@contextlib.contextmanager
def counted(name: str, held: bool, shapes: dict | None = None, calls: dict | None = None):
    """A block whose launch counts must be exactly those of what it ran
    (`recorded_paths`, `recorded_launches`), every kernel call held against
    its plain version where `held` (`checked_kernel_calls(mel=True)`).
    Yields a dict that gets "launches" and "seconds" when the block ends."""
    records: list = []
    box: dict = {}
    hold = (checked_kernel_calls({} if shapes is None else shapes, calls, mel=True) if held
            else contextlib.nullcontext())
    t0 = time.perf_counter()
    with hold, patched(*recorded_paths(records)):
        counters = zero_launches()
        yield box
        torch.cuda.synchronize()
        box["launches"] = read_launches(counters)
    box["seconds"] = time.perf_counter() - t0
    exact = recorded_launches(records)
    check_launches(name, box["launches"], tuple(k for k, v in exact.items() if v), exact)


def p9_decode(dev, name: str, arch, params, cfg, wav, held: bool, shapes=None, calls=None):
    """One batch of `make_transcribe_fn` (bf16 DFT mel, tanh GELU) with exact
    launch counts, held or not: (tokens, lengths, the block's box)."""
    from openai_whisper_compression_tpu_torch.evaluation.harness import make_transcribe_fn

    fn = make_transcribe_fn(arch, cfg, fast_mel=True, fast_gelu=True, device=dev)
    with counted(name, held, shapes, calls) as box, torch.inference_mode():
        toks, lens = fn(params, wav)
        toks, lens = toks.cpu(), lens.cpu()
    check(toks.shape[0] == wav.shape[0] and bool((lens == 4 + NEW_TOKENS).all()),
          f"{name}: tokens {tuple(toks.shape)} lengths {lens.tolist()}")
    return toks, lens, box


def contiguous_on_card(params) -> bool:
    """Every tensor of the tree (every QTensor field) contiguous on the card."""
    from openai_whisper_compression_tpu_torch.models.params import named_leaves
    from openai_whisper_compression_tpu_torch.ops.qtensor import QTensor

    return all(t.is_cuda and t.is_contiguous() for _, leaf in named_leaves(params)
               for t in (leaf._tensors() if isinstance(leaf, QTensor) else [leaf]))


def p9_through(dev, name: str, arch, params, ref, fmt: str, tmp: str, cfg, wav, want,
               results: dict) -> dict:
    """`params` written in `fmt` and read back onto the card: every leaf
    bit-equal to `ref` (the tree before saving, on the card or the host) and
    contiguous on the card, then one held decode whose tokens equal `want`
    (the in-memory tree's from this run). Logs write s, read s, file MB."""
    import os

    from openai_whisper_compression_tpu_torch.storage import formats

    save, load = formats.FORMATS[fmt]
    path = os.path.join(tmp, f"{name}.{fmt}")
    t0 = time.perf_counter()
    stats = save(params, path)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = load(path, device=dev)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    os.remove(path)
    bad = formats.trees_equal(loaded, ref)
    check(not bad, f"{name} {fmt}: leaves differ after the round trip: {bad[:5]}")
    check(contiguous_on_card(loaded), f"{name} {fmt}: a reloaded leaf is not contiguous "
          "on the card")
    shapes, calls = {}, {}
    toks, _, box = p9_decode(dev, f"{name}-{fmt}", arch, loaded, cfg, wav, True, shapes, calls)
    check(torch.equal(toks, want), f"{name} {fmt}: the reloaded tree's tokens differ from "
          "the in-memory tree's")
    extra = "".join(f", {k.replace('_', ' ')} {v}" for k, v in stats.items()
                    if k in ("sparse_tensors", "dense_tensors", "raw_mb"))
    log(f"phase9 storage-small {name} {fmt}: write {write_s:.2f} s, read {read_s:.2f} s, "
        f"{stats['file_mb']:.1f} MB{extra}; every leaf bit-equal; held batch of "
        f"{wav.shape[0]} in {box['seconds']:.2f} s, tokens equal the in-memory tree's; "
        f"launches {json.dumps(launched(box['launches']))}")
    results[f"p9_shapes_{name}"] = (shapes, calls)
    del loaded
    torch.cuda.empty_cache()
    return {"write_s": write_s, "read_s": read_s, "file_mb": stats["file_mb"],
            "launches": box["launches"], **{k: v for k, v in stats.items() if k != "file_mb"}}


def run_storage_small(dev, arch, int8_params, tmp: str, results: dict) -> dict:
    """storage-small: phase 2's int8 whisper-small tree through npz and gzip,
    an NF4 tree through gzip, an f32 tree pruned 80% (global L1) through the
    sparse zip, each cut to its first P9_STORE_LAYERS encoder and decoder
    layers (full width); each read back onto the card, bit-equal, decoded as
    one held batch to the in-memory tree's tokens (int8 caches, 25 tokens,
    EOT suppressed)."""
    from openai_whisper_compression_tpu_torch import runtime_native
    from openai_whisper_compression_tpu_torch.config import DecodeConfig
    from openai_whisper_compression_tpu_torch.models.params import (init_params, named_leaves,
                                                                    tree_to)
    from openai_whisper_compression_tpu_torch.prune.magnitude import prune_global_l1

    cfg = DecodeConfig(max_new_tokens=NEW_TOKENS, suppress_tokens=(arch.eos_token_id,), **KV8)
    wav = torch.from_numpy(waveforms(SEED + 90, P9_BATCH)).to(dev)
    log(f"phase9 storage-small: the sparse codec runs "
        f"{'natively (runtime/build/libowcruntime.so)' if runtime_native.available() else 'the numpy fallback'}")
    out = {}
    full = arch
    int8_params, arch = cut_layers(int8_params, full, P9_STORE_LAYERS)
    want, _, box = p9_decode(dev, "int8-in-memory", arch, int8_params, cfg, wav, False)
    out["int8-in-memory"] = {"launches": box["launches"]}
    for fmt in ("npz", "gzip"):
        out[f"int8-{fmt}"] = p9_through(dev, "int8", arch, int8_params, int8_params, fmt, tmp,
                                        cfg, wav, want, results)
    nf4, _ = cut_layers(make_params(dev, ARCH, "nf4")[1], arch, P9_STORE_LAYERS)
    want, _, _ = p9_decode(dev, "nf4-in-memory", arch, nf4, cfg, wav, False)
    host = tree_to(nf4, "cpu", torch.bfloat16)
    del nf4
    torch.cuda.empty_cache()
    out["nf4-gzip"] = p9_through(dev, "nf4", arch, host, host, "gzip", tmp, cfg, wav, want,
                                 results)
    del host
    pruned = prune_global_l1(cut_layers(init_params(full, seed=SEED, dtype=torch.float32,
                                                    device=dev), full, P9_STORE_LAYERS)[0],
                             P9_PRUNE)
    want, _, _ = p9_decode(dev, "sparse-f32-in-memory", arch, pruned, cfg, wav, False)
    host = tree_to(pruned, "cpu", torch.float32)
    del pruned
    torch.cuda.empty_cache()
    over = sum(1 for _, t in named_leaves(host)
               if t.dtype == torch.float32 and float((t == 0).float().mean()) > P9_SPARSE_AT)
    res = p9_through(dev, "sparse-f32", arch, host, host, "sparse_zip", tmp, cfg, wav, want,
                     results)
    log(f"phase9 storage-small sparse-f32: {res['sparse_tensors']} leaves stored sparse "
        f"(sparsity above {P9_SPARSE_AT}; {over} expected), {res['dense_tensors']} dense")
    check(res["sparse_tensors"] == over > 0, f"sparse-f32: {res['sparse_tensors']} leaves "
          f"stored sparse, {over} above the threshold")
    out["sparse-f32-sparse_zip"] = res
    return out


def run_hf_small(dev, arch, dense, tmp: str, results: dict) -> dict:
    """hf-small: the seeded bf16 whisper-small tree as an HF-named state dict
    (`to_hf_state_dict`) in a two-shard safetensors snapshot with the
    config.json and generation_config.json written here; `load_model(hf=dir,
    dtype=bf16)` onto the card: ARCHS["small"]'s dimensions, every leaf
    bit-equal and contiguous, one held batch with bf16 caches, tokens equal
    to the in-memory tree's."""
    import os

    from openai_whisper_compression_tpu_torch import load_model
    from openai_whisper_compression_tpu_torch.config import ARCHS, DecodeConfig
    from openai_whisper_compression_tpu_torch.models.convert import (to_hf_state_dict,
                                                                     write_safetensors)
    from openai_whisper_compression_tpu_torch.storage import formats

    cfg = DecodeConfig(max_new_tokens=NEW_TOKENS, suppress_tokens=(arch.eos_token_id,))
    wav = torch.from_numpy(waveforms(SEED + 91, P9_BATCH)).to(dev)
    want, _, _ = p9_decode(dev, "hf-in-memory", arch, dense, cfg, wav, False)
    snap = os.path.join(tmp, "whisper-small-snapshot")
    os.makedirs(snap)
    t0 = time.perf_counter()
    sd = to_hf_state_dict(dense)
    keys = list(sd)
    shards = {"model-00001-of-00002.safetensors": keys[: len(keys) // 2],
              "model-00002-of-00002.safetensors": keys[len(keys) // 2:]}
    weight_map = {}
    for fname, ks in shards.items():
        write_safetensors({k: sd[k] for k in ks}, os.path.join(snap, fname))
        weight_map.update({k: fname for k in ks})
    total = sum(v.numel() * v.element_size() for v in sd.values())
    with open(os.path.join(snap, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f)
    a = ARCHS[ARCH]
    with open(os.path.join(snap, "config.json"), "w") as f:
        json.dump({"vocab_size": a.vocab_size, "num_mel_bins": a.num_mel_bins,
                   "d_model": a.d_model, "encoder_layers": a.encoder_layers,
                   "encoder_attention_heads": a.encoder_heads,
                   "decoder_layers": a.decoder_layers,
                   "decoder_attention_heads": a.decoder_heads,
                   "encoder_ffn_dim": a.ffn_dim, "decoder_ffn_dim": a.ffn_dim,
                   "max_source_positions": a.max_source_positions,
                   "max_target_positions": a.max_target_positions,
                   "eos_token_id": a.eos_token_id, "pad_token_id": a.eos_token_id,
                   "bos_token_id": a.eos_token_id,
                   "decoder_start_token_id": a.decoder_start_token_id}, f)
    heads = [[5, 3], [7, 0], [9, 11], [10, 4]]
    with open(os.path.join(snap, "generation_config.json"), "w") as f:
        json.dump({"alignment_heads": heads,
                   "no_timestamps_token_id": a.no_timestamps_token_id}, f)
    write_s = time.perf_counter() - t0
    mb = sum(os.path.getsize(os.path.join(snap, n)) for n in os.listdir(snap)) / 2 ** 20
    del sd
    t0 = time.perf_counter()
    params, got = load_model(hf=snap, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    dims = ("vocab_size", "num_mel_bins", "d_model", "encoder_layers", "encoder_heads",
            "decoder_layers", "decoder_heads", "ffn_dim", "max_source_positions",
            "max_target_positions", "eos_token_id", "decoder_start_token_id",
            "no_timestamps_token_id", "multilingual")
    check(all(getattr(got, f) == getattr(a, f) for f in dims)
          and got.alignment_heads == tuple(map(tuple, heads)),
          f"hf-small: the loaded arch {got} is not ARCHS['small']'s")
    bad = formats.trees_equal(params, dense)
    check(not bad, f"hf-small: leaves differ from the tree written: {bad[:5]}")
    check(contiguous_on_card(params), "hf-small: a loaded leaf is not contiguous on the card")
    toks, _, box = p9_decode(dev, "hf-small", got, params, cfg, wav, True)
    check(torch.equal(toks, want), "hf-small: the loaded tree's tokens differ from the "
          "in-memory tree's")
    log(f"phase9 hf-small: {len(keys)} tensors in 2 safetensors shards, {mb:.1f} MB, "
        f"written in {write_s:.2f} s; load_model(hf=, dtype=bf16) {read_s:.2f} s; "
        f"ARCHS['small']'s dimensions, alignment heads {heads}; every leaf bit-equal; held "
        f"batch of {P9_BATCH} (bf16 caches) in {box['seconds']:.2f} s, tokens equal the "
        f"in-memory tree's; launches {json.dumps(launched(box['launches']))}")
    import shutil

    shutil.rmtree(snap)
    del params
    torch.cuda.empty_cache()
    return {"write_s": write_s, "read_s": read_s, "file_mb": mb, "launches": box["launches"]}


def run_sweep_small(dev, arch, dense, tmp: str) -> dict:
    """sweep-small: `run_sweep` over baseline_bf16, quanto_int8, quanto_int4
    and l1_global_50pct on `synthetic_dataset(32)` with `default_tokenizer`
    (batch 32, int8 caches, 25 tokens, EOT suppressed, no warmup), every
    kernel call held, launch counts exact; interrupted when the third config
    starts (a KeyboardInterrupt, which the driver does not isolate), then
    resumed: the resumed run applies configs 3-4 only and returns all four."""
    import os

    from openai_whisper_compression_tpu_torch.config import DecodeConfig, EvalConfig
    from openai_whisper_compression_tpu_torch.evaluation.data import synthetic_dataset
    from openai_whisper_compression_tpu_torch.evaluation.tokenizer import default_tokenizer
    from openai_whisper_compression_tpu_torch.sweep import configs, driver

    by_name = {c["name"]: c for c in configs.quant_sweep() + configs.unstructured_l1_sweep()}
    applied: list = []

    def tracked(cfg, interrupt: bool):
        def apply(p, a):
            applied.append(cfg["name"])
            if interrupt:
                raise KeyboardInterrupt(f"interrupted at {cfg['name']}")
            return cfg["apply"](p, a)
        return {**cfg, "apply": apply}

    datasets = {"test_clean": synthetic_dataset(P9_UTTS, seed=0)}
    kw = dict(eval_cfg=EvalConfig(batch_size=P9_BATCH, warmup_batches=0),
              decode_cfg=DecodeConfig(max_new_tokens=NEW_TOKENS,
                                      suppress_tokens=(arch.eos_token_id,), **KV8),
              save_path=os.path.join(tmp, "sweep"), device=dev)
    tok = default_tokenizer(arch)
    out = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)   # the evaluations' peak, not an earlier phase's
    with counted("sweep-small interrupted", True) as box:
        try:
            driver.run_sweep(dense, arch, [tracked(by_name[n], i == P9_INTERRUPT_AFTER)
                                           for i, n in enumerate(P9_SWEEP)],
                             datasets, tok, **kw)
            check(False, "sweep-small: the interrupt did not stop the sweep")
        except KeyboardInterrupt:
            pass
    with open(os.path.join(kw["save_path"], "all_results.json")) as f:
        saved = json.load(f)
    check(applied == list(P9_SWEEP[:P9_INTERRUPT_AFTER + 1])
          and set(saved) == set(P9_SWEEP[:P9_INTERRUPT_AFTER]) | {"_meta"}
          and not any("error" in saved[n] for n in P9_SWEEP[:P9_INTERRUPT_AFTER]),
          f"sweep-small: applied {applied}, flushed {sorted(saved)}")
    out["sweep-interrupted"] = {"launches": box["launches"]}
    log(f"phase9 sweep-small: interrupted at {P9_SWEEP[P9_INTERRUPT_AFTER]} after "
        f"{box['seconds']:.2f} s; all_results.json holds {sorted(k for k in saved if k[0] != '_')}")
    applied.clear()
    torch.cuda.reset_peak_memory_stats(dev)
    with counted("sweep-small resumed", True) as box:
        res = driver.run_sweep(dense, arch, [tracked(by_name[n], False) for n in P9_SWEEP],
                               datasets, tok, **kw)
    check(applied == list(P9_SWEEP[P9_INTERRUPT_AFTER:]),
          f"sweep-small: the resumed run applied {applied}")
    check(list(res) == list(P9_SWEEP) and not any("error" in r for r in res.values()),
          f"sweep-small: results {json.dumps(res, default=str)[:400]}")
    sizes = [res[n]["model_size_mb"] for n in P9_SWEEP]
    # global L1 prunes the linear weights alone, ~87% of whisper-small's values
    check(sizes[1] < sizes[0] and sizes[2] < sizes[1]
          and 0.3 < res["l1_global_50pct"]["sparsity"] < 0.5,
          f"sweep-small: sizes {sizes}, sparsity {res['l1_global_50pct']['sparsity']}")
    out["sweep-resumed"] = {"launches": box["launches"]}
    log(f"phase9 sweep-small: resumed in {box['seconds']:.2f} s (every kernel call held), "
        f"applied {applied} only; launches {json.dumps(launched(box['launches']))}")
    driver.summarize(res)   # the driver's table, on stdout
    for n in P9_SWEEP:
        s = res[n]["splits"]["test_clean"]
        vs = s.get("wer_vs_baseline")
        log(f"phase9 sweep-small {n}: size {res[n]['model_size_mb']:.1f} MiB, sparsity "
            f"{res[n]['sparsity']:.4f}, {res[n]['gflops']:.2f} GFLOPs, WER {s['wer']:.4f}, "
            f"wer_vs_baseline {'-' if vs is None else f'{vs:.4f}'}, rtfx {s['rtfx']:.2f} "
            f"(a held pass), peak {s['memory']['hbm_peak_mb']['max']:.1f} MiB (the allocator's "
            f"since its sweep run began, the resident trees of phases 2 and 7 included)")
    return out


def run_curve_small(dev, arch, dense, results: dict) -> dict:
    """The curve: `run_curve` over the int8, heads50+int8 and
    declayers-25%+int8 rungs (`ladder` cut to them), batch 32, int8 caches,
    25 tokens, recover_steps 0: a timed pass (iters 3; launch counts exact),
    then a held pass (iters 1, every kernel call held, counts exact) whose
    points equal the timed pass's in every field but rtfx."""
    from openai_whisper_compression_tpu_torch.sweep import curve

    real = curve.ladder
    kw = dict(quant="int8", batch=P9_BATCH, tokens=NEW_TOKENS, agreement_samples=P9_AGREE,
              recover_steps=0, progress=lambda m: log(f"phase9 {m.lstrip('# ')}"))
    cut = (curve, "ladder", lambda quant: [r for r in real(quant) if r[0] in P9_RUNGS])
    with patched(cut), counted("curve timed", False) as box:
        points = curve.run_curve(dense, arch, iters=P9_CURVE_ITERS, **kw)
    shapes, calls = {}, {}
    with patched(cut), counted("curve held", True, shapes, calls) as held:
        again = curve.run_curve(dense, arch, iters=1, **kw)
    check([p["name"] for p in points] == list(P9_RUNGS)
          and not any("error" in p for p in points + again),
          f"curve: points {points}, held {again}")
    for p, q in zip(points, again):
        check({k: v for k, v in p.items() if k != "rtfx"}
              == {k: v for k, v in q.items() if k != "rtfx"},
              f"curve: the held pass's {q} differs from the timed pass's {p}")
        log(f"phase9 curve {p['name']}: rtfx {p['rtfx']} (timed pass, {P9_CURVE_ITERS} "
            f"batches of {P9_BATCH}, median), size_mb {p['size_mb']}, hbm_mb {p['hbm_mb']}, "
            f"token_agreement {p['token_agreement']}, top1 {p['top1_agreement']}, mean_kl "
            f"{p['mean_kl']}, params_m {p['params_m']}")
    log(f"phase9 curve: timed pass {box['seconds']:.1f} s, held pass {held['seconds']:.1f} s; "
        f"launches {json.dumps(launched(held['launches']))}")
    results["p9_shapes_curve"] = (shapes, calls)
    return {"curve": {"points": points, "launches": box["launches"]},
            "curve-held": {"launches": held["launches"]}}


def phase9(dev, arch, int8_params, results: dict) -> dict:
    """Phase 9 (slice 16): storage-small, hf-small, sweep-small and the
    curve at whisper-small's full width (module docstring); each
    part's seconds printed; then the P9_ENTRIES shapes timed. Returns the
    runs' summaries."""
    import tempfile

    from openai_whisper_compression_tpu_torch.models.params import init_params

    summaries = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-p9-") as tmp:
        t0 = time.perf_counter()
        summaries.update(run_storage_small(dev, arch, int8_params, tmp, results))
        log(f"phase9 storage-small: {time.perf_counter() - t0:.1f} s")
        dense = init_params(arch, seed=SEED, dtype=torch.bfloat16, device=dev)
        t0 = time.perf_counter()
        summaries["hf-small"] = run_hf_small(dev, arch, dense, tmp, results)
        log(f"phase9 hf-small: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        summaries.update(run_sweep_small(dev, arch, dense, tmp))
        log(f"phase9 sweep-small: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        curve_tree, curve_arch = cut_layers(dense, arch, P9_CURVE_LAYERS)
        summaries.update(run_curve_small(dev, curve_arch, curve_tree, results))
        del curve_tree
        log(f"phase9 curve: {time.perf_counter() - t0:.1f} s")
        del dense
        torch.cuda.empty_cache()
    for entry, base, run, key in P9_ENTRIES:
        shapes, calls = results[f"p9_shapes_{run}"]
        check(key in shapes, f"phase9: {run} never called the {key} shape")
        count = calls[key].get(base, 0)
        check(count > 0, f"phase9: {run} never launched {base} at the {key} shape")
        results[entry] = {**time_p5_shape(f"{run} {entry}", key, shapes[key], phase="phase9"),
                          "launches": count}
    for k in [k for k in results if k.startswith("p9_shapes_")]:
        del results[k]
    return summaries


@torch.inference_mode()
def craft_ts_embeddings(params, arch, probe_mels: torch.Tensor, peak: float = 1.4) -> dict:
    """`params` with the timestamp band's token embeddings crafted so that a
    seeded model's closing timestamps land deep in the window and vary with
    the audio: the torch copy of `bench._craft_ts_embeddings` (held equal to
    it on test2l-ts by `tests/test_torch_longform.py`). Two teacher-forced
    probes find the dominant text token after the initial timestamp, then
    the closing decision's; the band's rows become that token's row scaled
    by the parabola 1 + a k/K - (k/K)^2 (a = `peak`: the preferred closing
    index is about K a / 2). The new embedding is bf16, as bench.py's; every
    other leaf is shared."""
    from openai_whisper_compression_tpu_torch.config import DecodeConfig
    from openai_whisper_compression_tpu_torch.models.decode import forced_prefix
    from openai_whisper_compression_tpu_torch.models.whisper import decode_logits, encode
    from openai_whisper_compression_tpu_torch.ops.qtensor import QTensor, dequantize

    ts_begin = arch.no_timestamps_token_id + 1
    k_band = arch.vocab_size - ts_begin
    prefix = forced_prefix(arch, DecodeConfig(notimestamps=False))
    text = np.arange(ts_begin)                    # the ids below the band
    n = probe_mels.shape[0]
    with torch.inference_mode():
        enc = encode(params, arch, probe_mels.to(params["encoder"]["ln"]["g"].dtype))

        def dominant(ids):
            t = torch.tensor([ids] * n, device=enc.device)
            logits = decode_logits(params, arch, t, enc)[:, -1].float().cpu().numpy()
            return int(np.bincount(logits[:, text].argmax(axis=1)).argmax())

        # the text-forced position after the initial timestamp, then the
        # closing decision [prefix, ts, text] whose hidden state scores the band
        dom0 = dominant(prefix + [ts_begin + 1])
        dom = dominant(prefix + [ts_begin + 1, dom0])
    emb = params["decoder"]["embed"]
    if isinstance(emb, QTensor):
        emb = dequantize(emb, torch.bfloat16)
    e = emb.float().cpu().numpy().copy()
    kk = (np.arange(k_band, dtype=np.float32) / k_band)[:, None]
    e[ts_begin:] = e[dom][None] * (1.0 + peak * kk - 1.0 * kk * kk)
    device = params["decoder"]["pos"].device
    return {**params, "decoder": {**params["decoder"], "embed": torch.from_numpy(e).to(
        device=device, dtype=torch.bfloat16)}}


def phase3(dev, params_for) -> None:
    """First-step logits of 2 utterances, card bf16 vs CPU f32, for each
    LOGIT_RUNS configuration of whisper-small (the CPU side deferred:
    `later`)."""
    from openai_whisper_compression_tpu_torch.audio.features import preprocess
    from openai_whisper_compression_tpu_torch.config import DecodeConfig
    from openai_whisper_compression_tpu_torch.models.decode import first_step_logits
    from openai_whisper_compression_tpu_torch.models.params import tree_to
    from openai_whisper_compression_tpu_torch.models.whisper import encode

    wav = torch.from_numpy(waveforms(SEED, 2))

    def logits(params, arch, cfgs, wav, dtype):
        mel = preprocess(wav, arch.num_mel_bins, dft_dtype=torch.bfloat16).to(dtype)
        enc = encode(params, arch, mel, fast_gelu=True)
        return {name: first_step_logits(params, arch, enc, cfg).float().cpu()
                for name, cfg in cfgs.items()}

    def compare(method, arch, cfgs, tag, card, card1, params_cpu):
        ref = logits(params_cpu, arch, cfgs, wav, torch.float32)
        for name in cfgs:
            c, r = card[name], ref[name]
            limit = {**ACT_LOGITS_REL_L2, **TREE_LOGITS_REL_L2}.get(method, LOGITS_REL_L2)
            rel = float((c - r).norm() / r.norm())
            agree = float((c.argmax(-1) == r.argmax(-1)).float().mean())
            log(f"phase3 {name} first-step logits card {tag} vs CPU f32: relative L2 "
                f"{rel:.4g} (bound {limit}), max abs {max_err(c, r):.4g}, "
                f"|logits| max {float(r.abs().max()):.4g}, argmax agreement "
                f"{agree:.2f} (not checked: random weights make argmax tie-prone)")
            check(bool(torch.isfinite(c).all()) and c.shape == (2, arch.vocab_size),
                  f"{name}: card logits not finite or of shape {tuple(c.shape)}")
            check(rel <= limit, f"{name}: card logits off by {rel:.4g} relative L2")
            if name in card1:   # the small-b1 run's shapes: one utterance
                c1 = card1[name]
                rel1 = float((c1 - r[:1]).norm() / r[:1].norm())
                log(f"phase3 {name} batch 1 first-step logits card bf16 vs CPU f32: "
                    f"relative L2 {rel1:.4g} (bound {LOGITS_REL_L2})")
                check(c1.shape == (1, arch.vocab_size) and rel1 <= LOGITS_REL_L2,
                      f"{name} batch 1: card logits off by {rel1:.4g} relative L2")

    for method in dict.fromkeys(m for _, m, _ in LOGIT_RUNS):
        arch, params = params_for(ARCH, method)
        cfgs = {name: DecodeConfig(max_new_tokens=25,
                                   suppress_tokens=(arch.eos_token_id,), **switches)
                for name, m, switches in LOGIT_RUNS if m == method}
        dtype = params["encoder"]["ln"]["g"].dtype   # bf16 but for the f32 and f16 trees
        tag = str(dtype).replace("torch.", "")
        card = logits(params, arch, cfgs, wav.to(dev), dtype)
        card1 = ({"int8 int8-kv": logits(params, arch, cfgs, wav[:1].to(dev), torch.bfloat16)[
            "int8 int8-kv"]} if "int8 int8-kv" in cfgs else {})
        later(f"phase3 {method}", functools.partial(
            compare, method, arch, cfgs, tag, card, card1,
            tree_to(params, "cpu", torch.float32)))

    # the beam5-prompt configuration: prompted, five beams per utterance
    arch, params = params_for(ARCH, "int8")
    cfg = DecodeConfig(max_new_tokens=NEW_TOKENS, suppress_tokens=(arch.eos_token_id,),
                       **BEAM5)
    prompt, lens = prompt_window(arch, SEED, 2)

    def beam_logits(params, wav, dtype):
        mel = preprocess(wav, arch.num_mel_bins, dft_dtype=torch.bfloat16).to(dtype)
        enc = encode(params, arch, mel, fast_gelu=True)
        return first_step_logits(params, arch, enc, cfg, prompt.to(wav.device),
                                 lens.to(wav.device)).float().cpu()

    c = beam_logits(params, wav.to(dev), torch.bfloat16)

    def beam_compare(params_cpu):
        r = beam_logits(params_cpu, wav, torch.float32)
        rel = float((c - r).norm() / r.norm())
        log(f"phase3 beam5-prompt first-step logits card bf16 vs CPU f32: relative L2 "
            f"{rel:.4g} (bound {LOGITS_REL_L2}), max abs {max_err(c, r):.4g}, |logits| "
            f"max {float(r.abs().max()):.4g}")
        check(bool(torch.isfinite(c).all()) and c.shape == (2 * 5, arch.vocab_size),
              f"beam5-prompt: card logits not finite or of shape {tuple(c.shape)}")
        check(rel <= LOGITS_REL_L2, f"beam5-prompt: card logits off by {rel:.4g} relative L2")

    later("phase3 beam5-prompt", functools.partial(beam_compare,
                                                   tree_to(params, "cpu", torch.float32)))


P10_TP_BATCH = 32     # TP decoder: 32 x 6 local heads = 192 rows, the grouped kernel
P10_TP_FEW = 3        # 3 x 6 = 18 rows: the one-query kernel
P10_DP_BATCH = 96     # DP transcription, the headline's batch
P10_CLI_SAMPLES = 32
P10_AGREE = 8
P10_WORLD_TIMEOUT_S = 600.0
# the parallel runs' depth: whisper-small's first 2 encoder and decoder
# layers (full width), in the two-process group and in the single-process
# runs it is held against
P10_LAYERS = 2
P10_ENTRIES = [
    ("int8_matmul@tp2-qkv-N384", "int8_matmul", ("int8_matmul", P10_TP_BATCH, 768, 384)),
    ("int8_matmul@tp2-o-K384", "int8_matmul", ("int8_matmul", P10_TP_BATCH, 384, 768)),
    ("int8_matmul@tp2-fc1-N1536", "int8_matmul", ("int8_matmul", P10_TP_BATCH, 768, 1536)),
    ("int8_matmul@tp2-fc2-K1536", "int8_matmul", ("int8_matmul", P10_TP_BATCH, 1536, 768)),
    ("encoder_attention@tp2-6heads", "encoder_attention", ("encoder_attention", 6, 1500)),
    ("transpose_quant_kv@tp2-6heads", "transpose_quant_kv", ("transpose_quant_kv", 1500, 384)),
    ("decode_cross_attention_grouped_int8@tp2-192rows", "decode_cross_attention_grouped_int8",
     ("grouped", "torch.int8", 1500, 1, P10_TP_BATCH * 6)),
]


def p10_tp_cfg(arch):
    """The TP decoder's configuration: 25 tokens, EOT suppressed, int8
    cross-KV (`transpose_quant_kv` on the local heads); its self-KV is fp,
    as the JAX function's."""
    from openai_whisper_compression_tpu_torch.config import DecodeConfig

    return DecodeConfig(max_new_tokens=NEW_TOKENS, suppress_tokens=(arch.eos_token_id,),
                        cross_kv_int8=True)


def p10_tree(dev):
    """The TP runs' tree: seeded bf16 whisper-small, int8 weights, qkv left
    unfused (a fused qkv is replicated under TP, as in the JAX package), cut
    to its first P10_LAYERS encoder and decoder layers (full width)."""
    from openai_whisper_compression_tpu_torch.config import ARCHS
    from openai_whisper_compression_tpu_torch.models.params import init_params
    from openai_whisper_compression_tpu_torch.quant.api import quantize_params

    arch = ARCHS[ARCH]
    tree = quantize_params(init_params(arch, seed=SEED, dtype=torch.bfloat16, device=dev),
                           "int8")
    tree, arch = cut_layers(tree, arch, P10_LAYERS)
    return arch, tree


def tree_digest(params) -> list:
    """One f64 sum and one abs-sum per tensor of the tree, in order (the
    two-process group's ranks hold the parent's tree)."""
    from openai_whisper_compression_tpu_torch.models.params import named_leaves
    from openai_whisper_compression_tpu_torch.ops.qtensor import QTensor

    out = []
    for _, leaf in named_leaves(params):
        for t in (leaf._tensors() if isinstance(leaf, QTensor) else [leaf]):
            d = t.double() if t.is_floating_point() else t.to(torch.float64)
            out.append((float(d.sum()), float(d.abs().sum())))
    return out


def p10_mels(dev, arch, seed: int, batch: int) -> torch.Tensor:
    """f32-DFT log-mels of a seeded batch, in bf16 (the TP runs' input: the
    TP encoder keeps the exact GELU, so the tie proofs' `cpu_enc(fast=False)`
    is its f32 twin)."""
    from openai_whisper_compression_tpu_torch.audio import features

    wav = torch.from_numpy(waveforms(seed, batch)).to(dev)
    return features.preprocess(wav, arch.num_mel_bins).to(torch.bfloat16), wav


def p10_world() -> dict:
    """One rank of the two-process group on the one card (gloo: NCCL
    refuses two ranks on one device): `make_tp_decoder` at tp = 2 over
    batches of 32 and 3, then `make_dp_transcribe` at dp = 2 over the
    headline batch of 96, each held (`checked_kernel_calls`: every
    shard-local launch against its plain version), the launches counted;
    rank 0 then times the shard-local shapes (P10_ENTRIES). Returns numpy
    results."""
    import torch.distributed as dist

    from openai_whisper_compression_tpu_torch.config import DecodeConfig
    from openai_whisper_compression_tpu_torch.evaluation.harness import samples_for_arch
    from openai_whisper_compression_tpu_torch.models.fuse import fuse_qkv
    from openai_whisper_compression_tpu_torch.ops import kernels
    from openai_whisper_compression_tpu_torch.parallel import mesh as mesh_lib
    from openai_whisper_compression_tpu_torch.parallel import steps, tp_forward

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kernels.lib()
    rank = dist.get_rank()
    arch, tree = p10_tree(dev)
    out = {"digest": tree_digest(tree), "backend": dist.get_backend()}
    tp_mesh = mesh_lib.make_mesh(dp=1, tp=2, device=dev)
    fn, place = tp_forward.make_tp_decoder(arch, tp_mesh, tree, p10_tp_cfg(arch))
    local = place(tree)
    out["local_shapes"] = {
        "q": tuple(local["decoder"]["layers"][0]["cross"]["q"]["w"].data.shape),
        "o": tuple(local["decoder"]["layers"][0]["cross"]["o"]["w"].data.shape),
        "fc1": tuple(local["decoder"]["layers"][0]["fc1"]["w"].data.shape),
        "fc2": tuple(local["decoder"]["layers"][0]["fc2"]["w"].data.shape)}
    shapes, calls = {}, {}
    for name, seed, batch in (("tp2", SEED + 110, P10_TP_BATCH),
                              ("tp2-b3", SEED + 111, P10_TP_FEW)):
        mel, _ = p10_mels(dev, arch, seed, batch)
        t0 = time.perf_counter()
        with checked_kernel_calls(shapes, calls) as held:
            counters = zero_launches()
            toks, lens = fn(local, mel)
            torch.cuda.synchronize()
            launches = read_launches(counters)
        out[name] = {"tokens": toks.cpu().numpy(), "lengths": lens.cpu().numpy(),
                     "launches": launches, "held": dict(held),
                     "seconds": time.perf_counter() - t0}
    del local
    dp_mesh = mesh_lib.make_mesh(dp=2, tp=1, device=dev)
    fused = fuse_qkv(tree)
    cfg = DecodeConfig(max_new_tokens=NEW_TOKENS, suppress_tokens=(arch.eos_token_id,), **KV8)
    dfn, dplace = steps.make_dp_transcribe(arch, dp_mesh, cfg, fast_mel=True, fast_gelu=True)
    wav_dp = waveforms(SEED + 112, P10_DP_BATCH)
    check(wav_dp.shape[1] == samples_for_arch(arch), "p10_world: wav width")
    rows = dplace(torch.from_numpy(wav_dp))
    t0 = time.perf_counter()
    with checked_kernel_calls({}, mel=True) as held:
        counters = zero_launches()
        toks, lens = dfn(fused, rows)
        torch.cuda.synchronize()
        launches = read_launches(counters)
    seconds = time.perf_counter() - t0
    out["dp2"] = {"tokens": mesh_lib.gather_batch(toks, dp_mesh).cpu().numpy(),
                  "lengths": mesh_lib.gather_batch(lens, dp_mesh).cpu().numpy(),
                  "rows": tuple(rows.shape), "launches": launches, "held": dict(held),
                  "seconds": seconds}
    out["staged"] = dict(mesh_lib.STAGED)
    dist.barrier()
    if rank == 0:   # the card is rank 0's alone from here
        timed = {}
        for entry, base, key in P10_ENTRIES:
            check(key in shapes, f"phase10: the TP decoder never called the {key} shape")
            count = calls[key].get(base, 0)
            check(count > 0, f"phase10: the TP decoder never launched {base} at {key}")
            timed[entry] = {**time_p5_shape(f"tp2 {entry}", key, shapes[key],
                                            phase="phase10"), "launches": count}
        out["timed"] = timed
    dist.barrier()
    return out


def run_cli_small(dev, tmp: str) -> dict:
    """The CLI in process (`cli.main([...])`, the card by default), on
    whisper-small with seeded weights, every call held
    (`checked_kernel_calls(mel=True)`: each launch inside a shim, held
    against its plain version) and its launches counted: `transcribe` of a
    60 s WAV (two 30 s windows, batch 2, bf16 tree) writing every format;
    `evaluate --quant quanto_int8 --kv-int8` on `synthetic_dataset(32)`;
    `compress --quant quanto_int8 --format gzip --verify`, `export --load` of that file
    to safetensors, and `transcribe --weights` of the export; `agreement
    --quant quanto_int8` over 8 utterances; `analyze`. Each result equals
    the package API's on the same inputs (texts, WER/CER, agreement
    metrics, the analysis)."""
    import os
    import wave

    from openai_whisper_compression_tpu_torch import cli
    from openai_whisper_compression_tpu_torch import transcribe as api_transcribe
    from openai_whisper_compression_tpu_torch.config import ARCHS, DecodeConfig, EvalConfig
    from openai_whisper_compression_tpu_torch.evaluation.agreement import model_agreement
    from openai_whisper_compression_tpu_torch.evaluation.data import (prepare_datasets,
                                                                      read_audio_file,
                                                                      synthetic_dataset)
    from openai_whisper_compression_tpu_torch.evaluation.harness import (evaluate_model,
                                                                         samples_for_arch)
    from openai_whisper_compression_tpu_torch.evaluation.tokenizer import default_tokenizer
    from openai_whisper_compression_tpu_torch.models.convert import load_checkpoint
    from openai_whisper_compression_tpu_torch.models.params import init_params, tree_cast
    from openai_whisper_compression_tpu_torch.quant.api import (apply_named_config,
                                                                dequantize_params)
    from openai_whisper_compression_tpu_torch.sensitivity import architecture
    from openai_whisper_compression_tpu_torch.storage import formats

    arch = ARCHS[ARCH]
    out = {}
    common = ["--model", ARCH, "--dtype", "bfloat16", "--seed", str(SEED)]

    def held_cli(name: str, argv: list, must: tuple):
        t0 = time.perf_counter()
        with checked_kernel_calls({}, mel=True) as held:
            counters = zero_launches()
            res = cli.main(argv)
            torch.cuda.synchronize()
            launches = read_launches(counters)
        secs = time.perf_counter() - t0
        missing = [k for k in must if not launches[k]]
        check(not missing, f"phase10 {name}: kernels of its path never launched: {missing}")
        out[name] = {"launches": launches, "seconds": secs}
        log(f"phase10 {name}: `cli {' '.join(a for a in argv if not a.startswith(tmp))}` "
            f"held in {secs:.2f} s; launches {json.dumps(launched(launches))}")
        return res

    # transcribe: a 60 s 16-bit WAV, every output format
    wav = np.concatenate(list(waveforms(SEED + 120, 2)))
    path = os.path.join(tmp, "long.wav")
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(16000)
        f.writeframes((np.clip(wav, -1, 1) * 32767).astype("<i2").tobytes())
    res = held_cli("cli-transcribe", ["transcribe", *common, "--audio", path,
                                      "--max-new-tokens", str(NEW_TOKENS), "--batch-size", "2",
                                      "-f", "all", "-o", os.path.join(tmp, "out")],
                   ("log_mel_cuda", "encoder_attention", "decode_cross_attention_grouped",
                    "decode_cross_attention", "decode_self_attention_update"))
    dense = init_params(arch, seed=SEED, dtype=torch.bfloat16, device=dev)
    cfg = DecodeConfig(max_new_tokens=NEW_TOKENS, beam_size=1, notimestamps=True,
                       kv_int8=False)
    want = api_transcribe(dense, arch, read_audio_file(path), decode_cfg=cfg, batch_size=2,
                          device=dev)
    check(res["text"] == want["text"] and res["num_chunks"] == want["num_chunks"] == 2,
          f"cli-transcribe: text {res['text'][:80]!r} != the API's {want['text'][:80]!r}")
    written = sorted(os.listdir(os.path.join(tmp, "out")))
    check(written == [f"long.{e}" for e in ("json", "srt", "tsv", "txt", "vtt")],
          f"cli-transcribe: wrote {written}")
    with open(os.path.join(tmp, "out", "long.txt")) as f:
        check(f.read().strip() == res["text"].strip(), "cli-transcribe: long.txt differs")
    # evaluate, int8 weights and caches
    scores = held_cli("cli-evaluate", ["evaluate", *common, "--quant", "quanto_int8",
                                       "--kv-int8", "--samples", str(P10_CLI_SAMPLES),
                                       "--batch-size", str(P10_CLI_SAMPLES),
                                       "--max-new-tokens", str(NEW_TOKENS)],
                      ("log_mel_cuda", "encoder_attention", "int8_matmul",
                       "decode_self_attention_update_int8"))
    q8 = apply_named_config(dense, "quanto_int8")
    ds = prepare_datasets(num_cal=4, num_test=P10_CLI_SAMPLES, seed=SEED)
    direct, _ = evaluate_model(
        q8, arch, ds["test_clean"], default_tokenizer(arch),
        EvalConfig(batch_size=P10_CLI_SAMPLES, split="test_clean", normalizer="basic"),
        DecodeConfig(max_new_tokens=NEW_TOKENS, notimestamps=True, kv_int8=True),
        device=dev)
    check(all(scores[k] == direct[k] for k in ("wer", "cer", "num_samples")),
          f"cli-evaluate: {[scores[k] for k in ('wer', 'cer')]} != the API's "
          f"{[direct[k] for k in ('wer', 'cer')]}")
    # compress, export, reload
    zpath, spath = os.path.join(tmp, "small.gz"), os.path.join(tmp, "small.safetensors")
    held_cli("cli-compress", ["compress", *common, "--quant", "quanto_int8", "--save", zpath,
                              "--format", "gzip", "--verify"], ())
    held_cli("cli-export", ["export", "--model", ARCH, "--load", zpath, "--out", spath], ())
    res = held_cli("cli-reload", ["transcribe", "--weights", spath, "--dtype", "bfloat16",
                                  "--audio", path, "--max-new-tokens", str(NEW_TOKENS),
                                  "--batch-size", "2"],
                   ("log_mel_cuda", "encoder_attention", "decode_self_attention_update"))
    stored = tree_cast(dequantize_params(formats.load_gzip(zpath, device=dev)),
                       torch.bfloat16)
    _, arch2 = load_checkpoint(spath, torch.bfloat16, "cpu")
    check(all(getattr(arch2, f) == getattr(arch, f) for f in (
        "vocab_size", "d_model", "encoder_layers", "decoder_layers", "encoder_heads",
        "decoder_heads", "ffn_dim", "eos_token_id", "decoder_start_token_id",
        "no_timestamps_token_id")), f"cli-reload: the export's arch {arch2}")
    want = api_transcribe(stored, arch2, read_audio_file(path), decode_cfg=cfg, batch_size=2,
                          device=dev)
    check(res["text"] == want["text"], "cli-reload: the export's transcript differs from "
          "the stored tree's")
    out["cli-export"]["file_mb"] = os.path.getsize(spath) / 2 ** 20
    os.remove(spath)
    del stored
    # agreement, int8 against the dense tree
    res = held_cli("cli-agreement", ["agreement", *common, "--quant", "quanto_int8",
                                     "--samples", str(P10_AGREE)],
                   ("log_mel_cuda", "encoder_attention", "int8_matmul"))
    n = samples_for_arch(arch)
    buf = np.zeros((P10_AGREE, n), np.float32)
    for i, u in enumerate(synthetic_dataset(P10_AGREE, seed=SEED)):
        buf[i, : min(len(u.audio), n)] = u.audio[:n]
    from openai_whisper_compression_tpu_torch.audio import features

    mels = features.preprocess(torch.from_numpy(buf).to(dev), arch.num_mel_bins,
                               length=n).to(torch.bfloat16)
    want = model_agreement(dense, q8, arch, mels)
    check(res == want, f"cli-agreement: {res} != the API's {want}")
    res = held_cli("cli-analyze", ["analyze", "--model", ARCH], ())
    check(res == architecture.analyze_model(init_params(arch, seed=SEED, device=dev)),
          "cli-analyze: the table differs from analyze_model's")
    del dense, q8
    torch.cuda.empty_cache()
    return out


def run_parallel_small(dev, tmp: str, int8_params) -> dict:
    """DP at world size 1 under NCCL, the TP and DP references, then the
    two-process gloo group on the one card (`p10_world`), every tree cut to
    P10_LAYERS layers (`int8_params`, whisper-small's fused int8 tree, as
    `p10_tree` cuts its own); its tokens equal
    the single-process runs' or part at a proven top-2 tie (`check_ties`, an
    f32 recompute on the card with every kernel's plain version)."""
    import os

    import torch.distributed as dist

    from openai_whisper_compression_tpu_torch.config import DecodeConfig
    from openai_whisper_compression_tpu_torch.evaluation.harness import make_transcribe_fn
    from openai_whisper_compression_tpu_torch.models.decode import forced_prefix
    from openai_whisper_compression_tpu_torch.models.params import tree_cast
    from openai_whisper_compression_tpu_torch.parallel import mesh as mesh_lib
    from openai_whisper_compression_tpu_torch.parallel import multihost, steps, tp_forward

    arch, tree = p10_tree(dev)
    int8_params, _ = cut_layers(int8_params, arch, P10_LAYERS)
    out = {}
    cfg = DecodeConfig(max_new_tokens=NEW_TOKENS, suppress_tokens=(arch.eos_token_id,), **KV8)
    wav_dp = waveforms(SEED + 112, P10_DP_BATCH)
    ref_fn = make_transcribe_fn(arch, cfg, fast_mel=True, fast_gelu=True, device=dev)
    with torch.inference_mode():
        dp_ref, dp_ref_len = (t.cpu() for t in ref_fn(int8_params, wav_dp))
    # world size 1 under NCCL
    info = multihost.initialize(None, 1, 0, "nccl", timeout_s=120.0,
                                init_method=f"file://{os.path.join(tmp, 'nccl-store')}")
    check(info["backend"] == "nccl", f"phase10: world of 1 on {info['backend']}")
    try:
        mesh1 = mesh_lib.make_mesh(dp=1, tp=1, device=dev)
        fn, place = steps.make_dp_transcribe(arch, mesh1, cfg, fast_mel=True, fast_gelu=True)
        with counted("dp-nccl-world1", True) as box:
            toks, lens = fn(int8_params, place(torch.from_numpy(wav_dp)))
            toks, lens = toks.cpu(), lens.cpu()
        check(torch.equal(toks, dp_ref) and torch.equal(lens, dp_ref_len),
              "dp-nccl-world1: tokens differ from make_transcribe_fn's")
        out["dp-nccl-world1"] = {"launches": box["launches"]}
        log(f"phase10 dp-nccl-world1: make_dp_transcribe on a world of 1 (NCCL), batch "
            f"{P10_DP_BATCH}, held in {box['seconds']:.2f} s, tokens equal "
            f"make_transcribe_fn's; launches {json.dumps(launched(box['launches']))}")
        # the TP decoder's single-process twin (tp = 1: every head local)
        tfn, tplace = tp_forward.make_tp_decoder(arch, mesh1, tree, p10_tp_cfg(arch))
        refs = {}
        for name, seed, batch in (("tp2", SEED + 110, P10_TP_BATCH),
                                  ("tp2-b3", SEED + 111, P10_TP_FEW)):
            mel, wav = p10_mels(dev, arch, seed, batch)
            toks, lens = tfn(tree, mel)
            refs[name] = (toks.cpu(), lens.cpu(), wav)
    finally:
        dist.destroy_process_group()
    t0 = time.perf_counter()
    ranks = multihost.run_world(p10_world, 2, backend="gloo",
                                timeout_s=P10_WORLD_TIMEOUT_S, threads=2)
    world_s = time.perf_counter() - t0
    digest = tree_digest(tree)
    for r, res in enumerate(ranks):
        check(res["digest"] == digest, f"phase10: rank {r}'s tree differs from this one's")
        check(res["backend"] == "gloo", f"phase10: rank {r} on {res['backend']}")
        check(res["local_shapes"] == {"q": (768, 384), "o": (384, 768), "fc1": (768, 1536),
                                      "fc2": (1536, 768)},
              f"phase10: rank {r}'s shard shapes {res['local_shapes']}")
    f32 = tree_cast(tree, torch.float32)
    tp_cfg = p10_tp_cfg(arch)
    with plain_kernels():
        for name in ("tp2", "tp2-b3"):
            want, want_len, wav = refs[name]
            parted = 0
            for r, res in enumerate(ranks):
                got = torch.from_numpy(res[name]["tokens"])
                check(torch.equal(got, torch.from_numpy(ranks[0][name]["tokens"])),
                      f"{name}: the two TP ranks' tokens differ")
                parted = check_ties(f"phase10 {name}", f32, arch, tp_cfg, wav.cpu(), got,
                                    want, len(forced_prefix(arch, tp_cfg)), fast=False,
                                    device=dev)
            res = ranks[0][name]
            path = ("int8_matmul", "encoder_attention", "transpose_quant_kv",
                    "decode_cross_attention_grouped_int8" if name == "tp2"
                    else "decode_cross_attention_int8")
            for r in ranks:
                missing = [k for k in path if not r[name]["launches"][k]]
                check(not missing, f"phase10 {name}: a rank never launched {missing}")
            out[name] = {"launches": res["launches"], "parted": parted}
            log(f"phase10 {name}: make_tp_decoder at tp = 2 on one card (two processes, "
                f"gloo), batch {want.shape[0]} ({want.shape[0] * 6} local (batch, head) "
                f"rows), held in {res['seconds']:.2f} s; tokens equal the tp = 1 run's"
                + (f" but for {parted} rows parted at proven ties" if parted else "")
                + f"; rank 0's launches {json.dumps(launched(res['launches']))}")
        got = torch.from_numpy(ranks[0]["dp2"]["tokens"])
        check(all(np.array_equal(r["dp2"]["tokens"], ranks[0]["dp2"]["tokens"])
                  for r in ranks), "dp2: the ranks' gathered tokens differ")
        parted = check_ties("phase10 dp2", tree_cast(int8_params, torch.float32),
                            arch, cfg, torch.from_numpy(wav_dp), got, dp_ref,
                            len(forced_prefix(arch, cfg)), device=dev)
    res = ranks[0]["dp2"]
    for r in ranks:
        missing = [k for k in ("log_mel_cuda", "encoder_attention", "int8_matmul",
                               "transpose_quant_kv", "decode_cross_attention_grouped_int8",
                               "decode_self_attention_update_int8") if not r["dp2"]["launches"][k]]
        check(not missing, f"phase10 dp2: a rank never launched {missing}")
    out["dp2"] = {"launches": res["launches"], "parted": parted}
    log(f"phase10 dp2: make_dp_transcribe at dp = 2 on one card, {res['rows'][0]} rows a "
        f"rank, held in {res['seconds']:.2f} s; gathered tokens equal make_transcribe_fn's "
        f"at batch {P10_DP_BATCH}" + (f" but for {parted} rows at proven ties" if parted
                                      else "")
        + f"; collectives staged through the host: {json.dumps(ranks[0]['staged'])}")
    log(f"phase10 two-process group: {world_s:.1f} s from spawn to the last rank's return")
    out["timed"] = ranks[0]["timed"]
    return out


def phase10(dev, int8_params, results: dict) -> dict:
    """Phase 10 (slice 17): the CLI in process, then the parallel paths
    (module docstring); P10_ENTRIES' shapes, timed by rank 0 of the
    two-process group, join `results`. Returns the runs' summaries."""
    import tempfile

    summaries = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-p10-") as tmp:
        t0 = time.perf_counter()
        summaries.update(run_cli_small(dev, tmp))
        log(f"phase10 cli: {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        par = run_parallel_small(dev, tmp, int8_params)
        log(f"phase10 parallel: {time.perf_counter() - t0:.1f} s")
    for entry, *_ in P10_ENTRIES:
        results[entry] = par["timed"][entry]
    del par["timed"]
    summaries.update(par)
    return summaries


# ---------------------------------------------------------------------------
# Slice 18: the attention kernels at every head dim (phase 1), the examples
# on the card (phase 11)
# ---------------------------------------------------------------------------

OTHER_DIMS = (16, 32, 128)    # the whole head dims besides every Whisper size's 64
# ragged head dims phase 1 holds (each the RAGGED body of its capacity: 16,
# 64, 128, 128 and 256; 36 and 100 leave bf16 rows off 16 bytes)
RAGGED_DIMS = (8, 36, 96, 100, 256)
# head dims past 256 phase 1 holds (the WIDE bodies; 384 also timed: the
# kernels line's `*_wide_dh` entries), over whisper-small's width where it
# holds them (768 // Dh heads), else one head
WIDE_DIMS = (257, 384, 512, 1024)
WIDE_TIMED = 384
WIDTH = 768                   # whisper-small's d_model, cut into 768 / Dh heads
LONG_CACHE = 16384            # the cache rows phase 1 holds (the cap was 12288)
P11_EXAMPLES = ("compress_store_serve", "qat_recovery", "serving_and_speculative",
                "streaming_live", "timestamps_and_profiling")
# the decode runs after the examples: test2l's bf16 tree over each cache
# kind at batch 4 (16 rows: the grouped kernel) and 3 (12: one-query)
P11_RUNS = [("test2l-bf16-kv", {}), ("test2l-int8-kv", KV8),
            ("test2l-int4-ckv", {"kv_int8": True, "cross_kv_int4": True})]
P11_BATCHES = (4, 3)
# the kernels head dim 16 reaches on phase 11's path, each timed at the
# first shape it met there (the kernels line's `name@test2l-<rows>rows`)
P11_BASES = ("decode_cross_attention_f32", "decode_cross_attention_grouped_f32",
             "decode_cross_attention_grouped_f32_wide", "decode_self_attention_update_f32",
             "decode_self_attention_update_f32_start", "decode_cross_attention",
             "decode_cross_attention_grouped", "decode_self_attention_update",
             "transpose_quant_kv", "decode_cross_attention_int8",
             "decode_cross_attention_grouped_int8", "decode_cross_attention_int4",
             "decode_cross_attention_grouped_int4", "decode_self_attention_update_int8")


# head dims no whole body has, on a model's path (phase 11): test2l at head
# dim 36 (d_model 144, 4 heads: the RAGGED bodies of capacity 64) over each
# cache kind in f32 and bf16 at P11_BATCHES, then whisper-small's width cut
# into 8 heads of 96 (`small-h8`: capacity 128's) at full depth, int8
# weights and caches, batch 32, greedy NEW_TOKENS, EOT suppressed; both
# configurations the JAX package runs as they stand (nothing in config.py)
P11_DH36 = {"name": "test2l-dh36", "d_model": 144, "encoder_heads": 4, "decoder_heads": 4,
            "ffn_dim": 576}
P11_DH36_RUNS = [(f"test2l-dh36-{tree}-{kv}", tree, switches)
                 for tree in ("f32", "bf16") for kv, switches in
                 (("fp", {}), ("int8", KV8),
                  ("int4", {"kv_int8": True, "cross_kv_int4": True}))]
P11_DH36_BASES = ("decode_cross_attention_f32", "decode_cross_attention_grouped_f32",
                  "decode_self_attention_update_f32", "decode_cross_attention",
                  "decode_cross_attention_grouped", "decode_self_attention_update",
                  "transpose_quant_kv", "decode_cross_attention_int8",
                  "decode_cross_attention_grouped_int8", "decode_cross_attention_int4",
                  "decode_cross_attention_grouped_int4", "decode_self_attention_update_int8")
P11_H8 = {"name": "small-h8", "encoder_heads": 8, "decoder_heads": 8}
P11_H8_BATCH = 32
P11_H8_PATH = ("log_mel_cuda", "encoder_attention", "transpose_quant_kv",
               "decode_cross_attention_grouped_int8", "decode_self_attention_update_int8",
               "int8_matmul")
# the RAGGED bodies small-h8 runs, each timed at the shape it met there
P11_H8_BASES = P11_H8_PATH[1:5]
# head dims past 256 on a model's path (the WIDE bodies): whisper-small's
# width cut into 2 heads of 384 (`small-h2`) run as small-h8 is (int8
# weights and caches, batch 32, full depth and a 2-layer cut against CPU
# f32; its WIDE bodies timed at its shapes), then the same cut's read-only
# replay (`run_self_attention_replay`); and test2l cut into 2 heads of 288
# (d_model 576) over each cache kind in f32 and bf16 at P11_BATCHES (the
# one-query WIDE body, the fp update's, int4 K/V), as test2l-dh36 runs
P11_H2 = {"name": "small-h2", "encoder_heads": 2, "decoder_heads": 2}
P11_WIDE = ("encoder_attention_wide_dh", "transpose_quant_kv_wide_dh",
            "decode_cross_attention_grouped_wide_dh", "decode_self_attention_update_int8_wide_dh")
P11_H2_PATH = P11_H8_PATH + P11_WIDE
P11_DH288 = {"name": "test2l-dh288", "d_model": 576, "encoder_heads": 2, "decoder_heads": 2,
             "ffn_dim": 2304}
P11_DH288_RUNS = [(f"test2l-dh288-{tree}-{kv}", tree, switches)
                  for tree in ("f32", "bf16") for kv, switches in
                  (("fp", {}), ("int8", KV8),
                   ("int4", {"kv_int8": True, "cross_kv_int4": True}))]
P11_DH288_BASES = ("decode_cross_attention_wide_dh", "decode_cross_attention_grouped_wide_dh",
                   "decode_self_attention_update_wide_dh",
                   "decode_self_attention_update_int8_wide_dh", "transpose_quant_kv_wide_dh")


def quantized_cross_kv(gen, bh: int, dh: int, s_pad: int, bits: int) -> tuple:
    """(k_t, v_t, k_scale, v_scale) of `bits` 8 or 4 (split-half int4),
    quantized by the plain quantizers from seeded values."""
    from openai_whisper_compression_tpu_torch.models.whisper import _quant_kv4_t
    from openai_whisper_compression_tpu_torch.ops.cross_attention import (
        transpose_quant_kv_ref)

    out = []
    for _ in range(2):
        x = torch.randn(1, s_pad, bh * dh, generator=gen, device=gen.device) * 0.4
        data, scale = transpose_quant_kv_ref(x, bh)
        if bits == 4:
            data, scale = _quant_kv4_t(data.float() * scale)
        out.append((data, scale))
    (k, ks), (v, vs) = out
    return k, v, ks, vs


def check_one_query(what: str, q: torch.Tensor, kv: tuple, s_valid: int,
                    phase: str = "phase1", timed: bool = True) -> dict:
    """The one-query cross-attention on q (BH, Dh) and kv = (k_t, v_t,
    k_scale, v_scale) against its plain version (within one step of q's
    type), one launch counted, timed warm and beside its bound and, for K/V
    in q's type, `sdpa`."""
    from openai_whisper_compression_tpu_torch.ops.cross_attention import (
        _FP_KIND, _KINDS, decode_cross_attention, decode_cross_attention_ref)

    bh, dh = q.shape
    k_t = kv[0]
    kind = _FP_KIND[q.dtype] if kv[2] is None else (
        "int8" if k_t.shape[1] == dh else "int4")
    attr = _KINDS[kind][2]
    before = getattr(decode_cross_attention, attr)
    got = decode_cross_attention(q, *kv, s_valid)
    check(getattr(decode_cross_attention, attr) == before + 1,
          f"{what}: {attr} did not count one launch")
    ref = decode_cross_attention_ref(q, *kv, s_valid)
    err, tol = max_err(got, ref), KERNEL_REL[q.dtype] * float(ref.float().abs().max())
    check(got.shape == (bh, dh) and err <= tol, f"{what}: err {err} > {tol}")
    if not timed:
        return held_only(phase, what, tuple(k_t.shape), err, tol)
    t_k = cuda_ms(lambda: decode_cross_attention(q, *kv, s_valid))
    t_p = cuda_ms(lambda: decode_cross_attention_ref(q, *kv, s_valid))
    least = bound(nbytes(q, got) + s_valid / k_t.shape[2] * nbytes(*kv),
                  4 * bh * dh * s_valid / peak_flops(q.dtype))
    t_lib = None
    if kv[2] is None:
        k, v = (t[:, :, :s_valid].transpose(1, 2) for t in kv[:2])
        t_lib = cuda_ms(lambda: sdpa(q[:, None, :], k, v, scale=1.0))
    log(f"{phase} {what} {tuple(k_t.shape)} s_valid {s_valid}: err {err:.3g} (bound "
        f"{tol:.3g}) kernel {t_k:.4f} ms plain {t_p:.4f} ms least {least['bound_ms']:.5f} "
        f"ms ({least['bound_by']})" + ("" if t_lib is None else f" sdpa {t_lib:.4f} ms"))
    return {"max_abs_err": err, "ms": t_k, "plain_ms": t_p, **least, "library_ms": t_lib}


def check_read_only(what: str, bh: int, dh: int, gen, int8: bool, timed: bool = True) -> dict:
    """The read-only self-attention at head dim dh, pos 30 of a 64-row
    cache (bf16 q), bit for bit against the update kernel's output on the
    cache it wrote, writing nothing, one launch counted; timed (unless not
    `timed`) beside its plain version, its bound (rows 0..30 of K and V
    read once) and, for an fp cache, `sdpa`. Returns the result entry."""
    from openai_whisper_compression_tpu_torch.ops import self_attention_step as sas

    dev = gen.device
    q = (torch.randn(bh, dh, generator=gen, device=dev) * dh ** -0.5).bfloat16()
    kn, vn = (torch.randn(2, bh, dh, generator=gen, device=dev) * 2).bfloat16()
    if int8:
        bufs = [*torch.randint(-127, 128, (2, bh, 64, dh), generator=gen, device=dev,
                               dtype=torch.int8),
                *(torch.rand(2, bh, 64, generator=gen, device=dev) * 0.03 + 1e-3)]
        upd, scales = sas.decode_self_attention_update_int8, {}
    else:
        bufs = [torch.randn(bh, 64, dh, generator=gen, device=dev).bfloat16()
                for _ in range(2)]
        upd = sas.decode_self_attention_update
    out = upd(q, kn, vn, *bufs, 30)
    written = [t.clone() for t in bufs]
    scales = {"k_scale": bufs[2], "v_scale": bufs[3]} if int8 else {}
    attr = "launches_int8" if int8 else "launches"
    before = getattr(sas.decode_self_attention, attr)
    got = sas.decode_self_attention(q, bufs[0], bufs[1], 30, **scales)
    check(getattr(sas.decode_self_attention, attr) == before + 1,
          f"{what}: {attr} did not count one launch")
    check(torch.equal(got, out) and all(torch.equal(a, b) for a, b in zip(bufs, written)),
          f"{what}: differs from the update kernel's output, or wrote to the cache")
    if not timed:
        return held_only("phase1", f"{what} pos=30", (bh, 64, dh), 0.0, 0.0)
    t_k = cuda_ms(lambda: sas.decode_self_attention(q, bufs[0], bufs[1], 30, **scales))
    t_p = cuda_ms(lambda: sas.decode_self_attention_ref(q, bufs[0], bufs[1], 30, **scales))
    t_lib = None
    if not int8:   # the library call over rows 0..30 of a cache in q's type
        k, v = bufs[0][:, :31], bufs[1][:, :31]
        t_lib = cuda_ms(lambda: sdpa(q[:, None, :], k, v, scale=1.0))
    rows = bh * 31
    least = bound(nbytes(q, got) + rows * 2 * dh * bufs[0].element_size()
                  + (rows * 8 if int8 else 0), 4 * rows * dh / BF16_FLOPS)
    log(f"phase1 {what} pos=30 ({bh}, 64, {dh}): equal to the update kernel's output bit "
        f"for bit; kernel {t_k:.4f} ms plain {t_p:.4f} ms least {least['bound_ms']:.5f} ms "
        f"({least['bound_by']})" + ("" if t_lib is None else f" sdpa {t_lib:.4f} ms"))
    return {"max_abs_err": max_err(got, sas.decode_self_attention_ref(
        q, bufs[0], bufs[1], 30, **scales)), "ms": t_k, "plain_ms": t_p, **least,
        "library_ms": t_lib}


def phase1_dim(dev, gen, dh: int, results: dict, timed: bool = True,
               heads: int | None = None) -> None:
    """The attention kernels at head dim dh over whisper-small's width cut into
    WIDTH // dh heads, or `heads` (module docstring, phase 1): the quantizer
    bit for bit in bf16 and f32, the encoder attention, the grouped (1 and 5
    slots) and one-query cross-attention over fp, int8 and int4 K/V, both
    updates with and without `start`, the read-only kernel bit for bit against
    the update; each held against its plain version, each launch counted, timed
    where `timed`. Results go to `results["dh<Dh> ..."]`."""
    from openai_whisper_compression_tpu_torch.models.whisper import split_heads
    from openai_whisper_compression_tpu_torch.ops import cross_attention as ca

    bf16, s_pad, s_valid = torch.bfloat16, 1536, 1500
    h = heads or WIDTH // dh
    width = h * dh
    tag = f"dh{dh}"
    for dtype in (bf16, torch.float32):
        x = (torch.randn(BATCH, s_valid, width, generator=gen, device=dev) * 0.4).to(dtype)
        before = ca.transpose_quant_kv.launches
        results[f"{tag} transpose_quant_kv {dtype}"] = check_tq(x, h, f"phase1 {tag}",
                                                                timed)[0]
        check(ca.transpose_quant_kv.launches > before, f"{tag}: tq launch not counted")
        del x
    for dtype in (bf16, torch.float16, torch.float32):   # the encoder in every type
        q, k, v = (split_heads((torch.randn(8, s_valid, width, generator=gen, device=dev)
                                ).to(dtype), h) for _ in range(3))
        suffix = "" if dtype == bf16 else f" {dtype}"
        results[f"{tag} encoder_attention{suffix}"] = check_enc_attn_shape(
            f"phase1 {tag} encoder_attention{suffix}", q, k, v, timed)
        del q, k, v
        torch.cuda.empty_cache()
    bh = BATCH * h
    fp = {dt: tuple(torch.randn(bh, dh, s_pad, generator=gen, device=dev).to(dt)
                    for _ in range(2)) + (None, None)
          for dt in (bf16, torch.float32, torch.float16)}
    kvq = {bits: quantized_cross_kv(gen, bh, dh, s_pad, bits)
           for bits in ((8, 4) if dh % 2 == 0 else (8,))}
    kinds = [("bf16", fp[bf16], bf16), ("f32", fp[torch.float32], torch.float32),
             ("f16", fp[torch.float16], torch.float16), ("int8", kvq[8], bf16)]
    kinds += [("int4", kvq[4], bf16)] if 4 in kvq else []
    for (name, kv, dtype), kq in [(kinds[0], 1), (kinds[0], 5)] + [(k, 1) for k in kinds[1:]]:
        qg = (torch.randn(bh, kq, dh, generator=gen, device=dev) * dh ** -0.5).to(dtype)
        attr = {"bf16": "launches", "f32": "launches_f32", "f16": "launches_f16",
                "int8": "launches_int8", "int4": "launches_int4"}[name]
        attr += "_wide" if kq > 4 else ""
        before = getattr(ca.decode_cross_attention_grouped, attr)
        results[f"{tag} grouped {name} K={kq}"] = check_grouped(
            f"{tag} cross_attention_grouped {name} K={kq}", qg, kv, s_valid, timed=timed)
        check(getattr(ca.decode_cross_attention_grouped, attr) > before,
              f"{tag} grouped {name}: {attr} did not count")
    rows = 3 * h
    for name, kv, dtype in kinds:
        q1 = (torch.randn(rows, dh, generator=gen, device=dev) * dh ** -0.5).to(dtype)
        results[f"{tag} one_query {name}"] = check_one_query(
            f"{tag} cross_attention {name} BH={rows}", q1,
            tuple(t[:rows] if t is not None else None for t in kv), s_valid, timed=timed)
    del fp, kvq, kinds
    start = (torch.arange(bh, device=dev) // h * 5 % 13).to(torch.int32)
    for dtype in (bf16, torch.float32, torch.float16):
        results[f"{tag} self_update {dtype}"] = check_update(
            f"{tag} self_attention_update {dtype}", bh, 30, gen, False, None, dtype, dh,
            timed=timed)
    results[f"{tag} self_update start"] = check_update(
        f"{tag} self_attention_update start", bh, 30, gen, False, start, bf16, dh,
        timed=timed)
    results[f"{tag} self_update_int8"] = check_update(
        f"{tag} self_attention_update_int8", bh, 30, gen, True, None, bf16, dh, timed=timed)
    results[f"{tag} self_update_int8 start"] = check_update(
        f"{tag} self_attention_update_int8 start", bh, 30, gen, True, start, bf16, dh,
        timed=timed)
    for int8 in (False, True):
        name = f"{tag} self_attention{'_int8' if int8 else ''}"
        results[name] = check_read_only(name, bh, dh, gen, int8, timed)
    torch.cuda.empty_cache()


# the calls past the grid's 65535 rows that phase 1 holds (slice 21): B*H
# of the encoder attention, clips of the log-mel, B and H of the cross-KV
# quantizer, M of the weight-only matmuls (65535 row tiles of 128, and one
# row more)
LIMIT_ROWS = 70000
LIMIT_M = 65535 * 128 + 1


def phase1_limits(dev, results: dict) -> None:
    """Each wrapper once past the grid's 65535 rows, held against its plain
    version and not timed: the encoder attention at B*H = 70000, T = 8 in
    bf16, f16 and f32 at Dh 64 and 288 (every body family), `log_mel_cuda`
    on (70000, 800) in both DFT types (no less exact than the plain version
    against float64), `transpose_quant_kv` at B = 70000 and at H = 70000
    (bit for bit), the int8 matmul at M = LIMIT_M, K = 32. The results go to
    `results["limit ..."]`, read by the log and PERF.md."""
    from openai_whisper_compression_tpu_torch.audio import features, mel_kernel
    from openai_whisper_compression_tpu_torch.models.whisper import split_heads
    from openai_whisper_compression_tpu_torch.ops import cross_attention as ca
    from openai_whisper_compression_tpu_torch.ops import quant_matmul as qm

    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    t0 = time.perf_counter()
    b, h = LIMIT_ROWS // 2, 2
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        for dh in (64, 288):
            q, k, v = (split_heads(torch.randn(b, 8, h * dh, generator=gen, device=dev)
                                   .to(dtype), h) for _ in range(3))
            results[f"limit encoder_attention {dtype} dh{dh}"] = check_enc_attn_shape(
                f"phase1 limit encoder_attention {dtype}", q, k, v, timed=False)
    del q, k, v
    wav = torch.randn(LIMIT_ROWS, 800, generator=gen, device=dev) * 0.1
    for dtype in (torch.float32, torch.bfloat16):
        got = mel_kernel.log_mel_cuda(wav, 80, dtype)
        ref = features.log_mel(wav, 80, dtype)
        check(got.shape == (LIMIT_ROWS, 80, 5), f"limit mel: shape {tuple(got.shape)}")
        mel_exactness(f"limit ({LIMIT_ROWS}, 800) {dtype}", wav, got, ref, 80, dtype)
        results[f"limit mel {dtype}"] = {"max_abs_err": max_err(got, ref)}
    del wav, got, ref
    for b, h in ((LIMIT_ROWS, 1), (1, LIMIT_ROWS)):
        x = (torch.randn(b, 8, h * 64, generator=gen, device=dev) * 0.4).to(torch.bfloat16)
        got, ref = ca.transpose_quant_kv(x, h), ca.transpose_quant_kv_ref(x, h)
        check(all(torch.equal(a, r) for a, r in zip(got, ref)),
              f"limit transpose_quant_kv B={b} H={h}: differs from the plain version")
        results[f"limit transpose_quant_kv B={b} H={h}"] = {"max_abs_err": 0.0}
    del x, got, ref
    x = torch.randn(LIMIT_M, 32, generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randint(-127, 128, (32, 64), generator=gen, device=dev, dtype=torch.int8)
    scale = torch.rand(64, generator=gen, device=dev) * 0.01
    got, ref = qm.int8_matmul(x, w, scale), qm.int8_matmul_ref(x, w, scale)
    err, tol = max_err(got, ref), BF16_REL * float(ref.float().abs().max())
    check(err <= tol, f"limit int8_matmul M={LIMIT_M}: err {err} > {tol}")
    results["limit int8_matmul"] = {"max_abs_err": err}
    del x, got, ref
    torch.cuda.empty_cache()
    log(f"phase1 limits: B*H, B, H = {LIMIT_ROWS} and M = {LIMIT_M} held (codes equal, "
        f"int8_matmul err {err:.3g} of {tol:.3g}) in {time.perf_counter() - t0:.1f} s")


def phase1_head_dims(dev, results: dict) -> None:
    """The attention kernels at head dims 16, 32 and 128 and at the
    RAGGED_DIMS, each call held (`phase1_dim`; `tools/torch_attention_ab.py`
    times them); the f32 grouped body at 128 over BATCH * 6 rows, one slot
    (its repaired body), timed against its plain version; then one strided
    or offset call a wrapper and both updates over a LONG_CACHE-row cache.
    The results go to `results["dh<Dh> ..."]`, read by the log and PERF.md,
    not by the kernels line."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    bf16 = torch.bfloat16
    t0 = time.perf_counter()
    for dh in OTHER_DIMS + RAGGED_DIMS:
        phase1_dim(dev, gen, dh, results, timed=False)
    log(f"phase1 head dims {OTHER_DIMS + RAGGED_DIMS} held in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for dh in WIDE_DIMS:
        phase1_dim(dev, gen, dh, results, timed=dh == WIDE_TIMED, heads=max(1, WIDTH // dh))
    log(f"phase1 WIDE head dims {WIDE_DIMS} held ({WIDE_TIMED} timed) in "
        f"{time.perf_counter() - t0:.1f} s")
    bh = BATCH * WIDTH // 128
    kv = tuple(torch.randn(bh, 128, 1536, generator=gen, device=dev) for _ in range(2))
    q = torch.randn(bh, 1, 128, generator=gen, device=dev) * 128 ** -0.5
    results["dh128 grouped f32 K=1"] = check_grouped(
        f"dh128 cross_attention_grouped f32 K=1 ({bh} rows)", q, (*kv, None, None), 1500)
    del kv, q
    phase1_views(dev, gen, results)
    for int8 in (False, True):
        results[f"long self_update{'_int8' if int8 else ''}"] = check_update(
            f"self_attention_update{'_int8' if int8 else ''} S={LONG_CACHE}", BATCH * 12,
            LONG_CACHE - 1, gen, int8, None, bf16, 64, LONG_CACHE)
    torch.cuda.empty_cache()


def phase1_views(dev, gen, results: dict) -> None:
    """One call a wrapper on the views a caller may hand it (head dim 64,
    whisper-small's batch-32 rows): q as a slice of a fused (BH, 3 x 64)
    projection (both cross-attentions, both updates), K/V and scales at
    storage offsets that break 16-byte loads, the cross-KV projection's k
    half, the encoder's k at an offset, caches as prefix views of longer
    buffers (written through copies): each against its plain version (caches
    and codes bit for bit), one launch counted, timed beside the same call on
    contiguous inputs (what the copies cost)."""
    from openai_whisper_compression_tpu_torch.models.whisper import split_heads
    from openai_whisper_compression_tpu_torch.ops import attention as att
    from openai_whisper_compression_tpu_torch.ops import cross_attention as ca
    from openai_whisper_compression_tpu_torch.ops import self_attention_step as sas

    bf16, h, s_pad, s_valid = torch.bfloat16, 12, 1536, 1500
    bh = BATCH * h

    def offset(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        return flat[1:].view(t.shape).copy_(t)

    def held(what, wrapper, attr, call, plain, contiguous, equal=()):
        before = getattr(wrapper, attr)
        got = call()
        check(getattr(wrapper, attr) == before + 1, f"views {what}: {attr} not counted")
        ref = plain()
        outs = got if isinstance(got, tuple) else (got,)
        refs = ref if isinstance(ref, tuple) else (ref,)
        for a, b in zip(outs, refs):
            if a.dtype in (torch.int8, torch.float32) and what.startswith("transpose"):
                check(torch.equal(a, b), f"views {what}: codes or scales differ")
            else:
                err, tol = max_err(a, b), KERNEL_REL[a.dtype] * float(b.float().abs().max())
                check(err <= tol, f"views {what}: err {err} > {tol}")
        for a, b in equal:
            check(torch.equal(a, b), f"views {what}: caches differ from the plain version's")
        t_v, t_c = cuda_ms(call), cuda_ms(contiguous)
        results[f"views {what}"] = {"ms": t_v, "contiguous_ms": t_c}
        log(f"phase1 views {what}: held; kernel {t_v:.4f} ms, on contiguous inputs "
            f"{t_c:.4f} ms")

    fused = (torch.randn(bh, 3, 64, generator=gen, device=dev) * 0.125).to(bf16)
    k_t, v_t = (torch.randn(bh, 64, s_pad, generator=gen, device=dev).to(bf16)
                for _ in range(2))
    k8 = quantized_cross_kv(gen, bh, 64, s_pad, 8)
    k8o = tuple(offset(t) for t in k8)
    q1 = fused[:, 1]
    held("decode_cross_attention q slice, int8 K/V and scales at offsets",
         ca.decode_cross_attention, "launches_int8",
         lambda: ca.decode_cross_attention(q1, *k8o, s_valid),
         lambda: ca.decode_cross_attention_ref(q1, *k8o, s_valid),
         lambda: ca.decode_cross_attention(q1.contiguous(), *k8, s_valid))
    qg = fused[:, 1:]
    k_o = offset(k_t)
    held("decode_cross_attention_grouped 2-slot q slice, bf16 K at an offset",
         ca.decode_cross_attention_grouped, "launches",
         lambda: ca.decode_cross_attention_grouped(qg, k_o, v_t, s_valid=s_valid),
         lambda: ca.decode_cross_attention_grouped_ref(qg, k_o, v_t, s_valid=s_valid),
         lambda: ca.decode_cross_attention_grouped(qg.contiguous(), k_t, v_t,
                                                   s_valid=s_valid))
    del k_t, v_t, k8, k8o, k_o
    proj = (torch.randn(BATCH, s_valid, 2 * 768, generator=gen, device=dev) * 0.4).to(bf16)
    x = proj[..., :768]
    held("transpose_quant_kv k half of a fused K/V projection", ca.transpose_quant_kv,
         "launches", lambda: ca.transpose_quant_kv(x, h),
         lambda: ca.transpose_quant_kv_ref(x, h),
         lambda: ca.transpose_quant_kv(x.contiguous(), h))
    del proj, x
    q, k, v = (split_heads(torch.randn(8, s_valid, 768, generator=gen, device=dev).to(bf16),
                           h) for _ in range(3))
    k_off = offset(k.contiguous())
    held("encoder_attention k at an offset", att.encoder_attention, "launches",
         lambda: att.encoder_attention(q, k_off, v),
         lambda: att.encoder_attention_ref(q, k_off, v),
         lambda: att.encoder_attention(q, k, v))
    del q, k, v, k_off
    rows = (torch.randn(bh, 3 * 64, generator=gen, device=dev) * 0.5).to(bf16)
    qf, kn, vn = (rows[:, i * 64: (i + 1) * 64] for i in range(3))
    for int8 in (False, True):
        if int8:
            big = [*torch.randint(-127, 128, (2, bh, 80, 64), generator=gen, device=dev,
                                  dtype=torch.int8),
                   *(torch.rand(2, bh, 80, generator=gen, device=dev) * 0.03 + 1e-3)]
            upd, plain = (sas.decode_self_attention_update_int8,
                          sas.decode_self_attention_update_int8_ref)
        else:
            big = [torch.randn(bh, 80, 64, generator=gen, device=dev).to(bf16)
                   for _ in range(2)]
            upd, plain = sas.decode_self_attention_update, sas.decode_self_attention_update_ref
        views = [t[:, :64] for t in big]
        refs = [t.contiguous() for t in views]
        tails = [t[:, 64:].clone() for t in big]
        held(f"self_attention_update{'_int8' if int8 else ''} q/k/v slices, prefix-view caches",
             upd, "launches", lambda: upd(qf, kn, vn, *views, 30),
             lambda: plain(qf, kn, vn, *refs, 30, None),
             lambda: upd(qf.contiguous(), kn.contiguous(), vn.contiguous(), *refs, 30),
             equal=list(zip(views, refs)))
        check(all(torch.equal(t[:, 64:], tail) for t, tail in zip(big, tails)),
              "views: an update wrote past its prefix view")
        scales = {"k_scale": views[2], "v_scale": views[3]} if int8 else {}
        held(f"self_attention{'_int8' if int8 else ''} on prefix-view caches",
             sas.decode_self_attention, "launches_int8" if int8 else "launches",
             lambda: sas.decode_self_attention(qf, views[0], views[1], 30, **scales),
             lambda: sas.decode_self_attention_ref(qf, views[0], views[1], 30, **scales),
             lambda: sas.decode_self_attention(qf.contiguous(), refs[0], refs[1], 30,
                                               **({"k_scale": refs[2], "v_scale": refs[3]}
                                                  if int8 else {})))


def time_p11_shape(what: str, key: tuple, args: tuple) -> dict:
    """A kernel at a shape phase 11 gave it, on the first call's inputs,
    against its plain version, timed beside it and its bound."""
    from openai_whisper_compression_tpu_torch.ops import self_attention_step as sas

    kind = key[0]
    if kind == "one_query":
        q, kv, s_valid = args
        return check_one_query(what, q, kv, s_valid, phase="phase11")
    if kind == "decode_self_attention_update":
        q, kn, vn, kc, vc, pos, start = args
        refs = [t.clone() for t in (kc, vc)]
        got = sas.decode_self_attention_update(q, kn, vn, kc, vc, pos, start=start)
        ref = sas.decode_self_attention_update_ref(q, kn, vn, *refs, pos, start)
        err, tol = max_err(got, ref), KERNEL_REL[q.dtype] * float(ref.float().abs().max())
        check(all(torch.equal(a, r) for a, r in zip((kc, vc), refs)) and err <= tol,
              f"{what}: caches differ or err {err} > {tol}")
        t_k = cuda_ms(lambda: sas.decode_self_attention_update(q, kn, vn, kc, vc, pos,
                                                               start=start))
        t_p = cuda_ms(lambda: sas.decode_self_attention_update_ref(q, kn, vn, kc, vc, pos,
                                                                   start))
        bh, dh = q.shape
        rows = bh * (pos + 1) - (0 if start is None else int(start.sum()))
        per_row = 2 * dh * kc.element_size()
        least = bound(nbytes(q, kn, vn, got) + per_row * (rows + bh),
                      4 * dh * rows / peak_flops(q.dtype))
        log(f"phase11 {what} fp update ({bh} rows, {kc.shape[1]}-row cache, {q.dtype}) "
            f"pos={pos}: err {err:.3g} (bound {tol:.3g}) caches equal; kernel {t_k:.4f} ms "
            f"plain {t_p:.4f} ms least {least['bound_ms']:.5f} ms ({least['bound_by']})")
        return {"max_abs_err": err, "ms": t_k, "plain_ms": t_p, **least, "library_ms": None}
    return time_p5_shape(what, key, args, phase="phase11")


@torch.inference_mode()
def run_p11_decodes(dev, shapes: dict, calls: dict, arch=None, runs=None) -> dict:
    """`runs` (P11_RUNS: name, tree dtype, switches) at P11_BATCHES, held, on
    `arch`'s (test2l's) seeded tree: tokens and lengths of the expected
    shapes, finite; the launches of each run."""
    import numpy as np

    from openai_whisper_compression_tpu_torch.config import ARCHS, DecodeConfig
    from openai_whisper_compression_tpu_torch.evaluation.harness import (
        make_transcribe_fn, samples_for_arch)
    from openai_whisper_compression_tpu_torch.models.params import init_params, tree_to

    arch = arch or ARCHS["test2l"]
    params = init_params(arch, SEED, torch.bfloat16, dev)
    trees = {"bf16": params, "f32": tree_to(params, dev, torch.float32)}
    out = {}
    for name, tree, switches in runs or [(n, "bf16", sw) for n, sw in P11_RUNS]:
        params = trees[tree]
        cfg = DecodeConfig(max_new_tokens=8, language_token_id=None, task_token_id=None,
                           **switches)
        fn = make_transcribe_fn(arch, cfg, device=dev)
        counters = zero_launches()
        for b in P11_BATCHES:
            wav = (np.random.default_rng(b).standard_normal((b, samples_for_arch(arch)))
                   * 0.1).astype(np.float32)
            with checked_kernel_calls(shapes, calls, mel=True):
                toks, lens = fn(params, wav)
            check(toks.shape[0] == b and bool((lens > 0).all()),
                  f"phase11 {name} batch {b}: tokens {tuple(toks.shape)}")
        out[name] = {"launches": read_launches(counters)}
        log(f"phase11 {name}: launches {json.dumps(launched(out[name]['launches']))}")
    return out


def phase11(dev, results: dict) -> dict:
    """Phase 11 (slice 18): the examples on the card, held, then
    P11_RUNS; every kernel of P11_BASES launched; the P11 shapes timed into
    `results` as `name@test2l-<rows>rows`; then P11_DH36_RUNS and small-h8
    (`run_small_h8`), their ragged bodies timed likewise. Returns the runs'
    summaries."""
    import importlib
    import io

    summaries, shapes, calls = {}, {}, {}
    for name in P11_EXAMPLES:
        mod = importlib.import_module(f"examples_torch.{name}")
        t0 = time.perf_counter()
        counters = zero_launches()
        buf = io.StringIO()
        with checked_kernel_calls(shapes, calls, mel=True) as held_:
            with contextlib.redirect_stdout(buf):
                got = mod.main(["--device", str(dev)])
        printed = buf.getvalue()
        summaries[name] = {"launches": read_launches(counters)}
        tail = printed.strip().splitlines()[-1] if printed.strip() else ""
        log(f"phase11 {name}: {time.perf_counter() - t0:.1f} s, {len(printed.splitlines())} "
            f"lines printed (last: {tail!r}); {held_summary(held_, {})}; launches "
            f"{json.dumps(launched(summaries[name]['launches']))}")
        if name == "compress_store_serve":
            check(got["roundtrip_ok"] and got["num_chunks"] >= 1,
                  f"phase11 {name}: {got}")
        elif name == "qat_recovery":
            check(printed.rstrip().endswith("OK"), f"phase11 {name}: no OK line")
        elif name == "serving_and_speculative":
            log(f"phase11 {name}: speculative == greedy: {got['speculative_exact']}")
            check(len(got["requests"]) == 3, f"phase11 {name}: {got['requests']}")
        elif name == "streaming_live":
            check(len(got["ticks"]) == len(got["single"]) > 0, f"phase11 {name}")
        else:
            plotted = ("matplotlib is not installed" in printed) or ("Plot saved" in printed)
            check(got["num_windows"] > 0 and plotted, f"phase11 {name}: {got['num_windows']} "
                  "windows, or no plot line")
    summaries.update(run_p11_decodes(dev, shapes, calls))
    total = {k: sum(s["launches"][k] for s in summaries.values()) for k in P11_BASES}
    log(f"phase11 head-dim-16 launches {json.dumps(total)}")
    p11_entries(results, "test2l", P11_BASES, total, shapes, calls)
    # head dim 36: the RAGGED bodies of capacity 64
    from openai_whisper_compression_tpu_torch.config import ARCHS

    t0 = time.perf_counter()
    shapes36, calls36 = {}, {}
    runs36 = run_p11_decodes(dev, shapes36, calls36, ARCHS["test2l"].replace(**P11_DH36),
                             P11_DH36_RUNS)
    summaries.update(runs36)
    total = {k: sum(s["launches"][k] for s in runs36.values()) for k in P11_DH36_BASES}
    log(f"phase11 head-dim-36 runs held in {time.perf_counter() - t0:.1f} s; launches "
        f"{json.dumps(total)}")
    p11_entries(results, "test2l-dh36", P11_DH36_BASES, total, shapes36, calls36)
    summaries.update(run_small_h8(dev, results))
    # head dims past 256: the WIDE bodies on a model's path
    t0 = time.perf_counter()
    shapes288, calls288 = {}, {}
    runs288 = run_p11_decodes(dev, shapes288, calls288, ARCHS["test2l"].replace(**P11_DH288),
                              P11_DH288_RUNS)
    summaries.update(runs288)
    total = {k: sum(s["launches"][k] for s in runs288.values()) for k in P11_DH288_BASES}
    log(f"phase11 head-dim-288 runs held in {time.perf_counter() - t0:.1f} s; launches "
        f"{json.dumps(total)}")
    p11_entries(results, "test2l-dh288", P11_DH288_BASES, total, shapes288, calls288)
    summaries.update(run_small_h8(dev, results, P11_H2, 384, P11_H2_PATH, P11_WIDE))
    return summaries


def p11_entries(results: dict, label: str, bases, total: dict, shapes: dict,
                calls: dict) -> None:
    """Every kernel of `bases` launched (`total`) and timed at the first
    shape it met (`shapes`, `calls` of a `checked_kernel_calls` block) into
    `results` as `name@<label>-<rows>rows` (the kernels line's entries)."""
    for base in bases:
        check(total[base] > 0, f"phase11: {base} was never launched on {label}'s path")
        key = next(k for k in shapes if calls.get(k, {}).get(base, 0) > 0)
        if key[0] == "transpose_quant_kv":
            entry = f"{base}@{label}-{key[1]}x{key[2]}"
        elif key[0] == "encoder_attention":
            entry = f"{base}@{label}-" + "x".join(map(str, key[1:]))
        else:   # the updates' keys hold the rows third, the cross-attentions' last
            rows = key[2] if key[0].startswith("decode_self") else key[-1]
            entry = f"{base}@{label}-{rows}rows" + (
                f"-{key[3]}slots" if key[0] == "grouped" and key[3] > 1 else "")
        with torch.inference_mode():   # the recorded inputs are inference tensors
            results[entry] = {**time_p11_shape(entry, key, shapes[key]),
                              "launches": total[base], "base": base}


def run_small_h8(dev, results: dict, spec: dict = P11_H8, head_dim: int = 96,
                 path: tuple = P11_H8_PATH, bases: tuple = P11_H8_BASES) -> dict:
    """small-h8 (P11_H8), or another head split of whisper-small (`spec`,
    whose head dim must be `head_dim`: small-h2's 384), cut to
    P8_PROOF_LAYERS layers and at full depth through `make_transcribe_fn`,
    one batch each held (`checked_kernel_calls(mel=True)`), launch counts
    exact over `path`; the cut's first REF_ROWS rows against CPU f32 (a
    thread beside the full-depth run, joined last): tokens equal or parted
    at a tie proven there; the bodies of `bases` timed at its shapes. Past
    head dim 256 the cut also runs the read-only replay
    (`run_self_attention_replay`), the WIDE read-only body's path."""
    from openai_whisper_compression_tpu_torch.config import ARCHS, DecodeConfig
    from openai_whisper_compression_tpu_torch.evaluation.harness import make_transcribe_fn
    from openai_whisper_compression_tpu_torch.models.fuse import fuse_qkv
    from openai_whisper_compression_tpu_torch.models.params import init_params, tree_to
    from openai_whisper_compression_tpu_torch.quant.api import quantize_params

    label = spec["name"]
    arch = ARCHS["small"].replace(**spec)
    check(arch.head_dim == head_dim, f"{label}'s head dim {arch.head_dim}")
    params = fuse_qkv(quantize_params(init_params(arch, SEED, torch.bfloat16, dev), "int8"))
    cfg = DecodeConfig(max_new_tokens=NEW_TOKENS, suppress_tokens=(arch.eos_token_id,), **KV8)
    wav = torch.from_numpy(waveforms(SEED + 110, P11_H8_BATCH)).to(dev)
    out, proof = {}, None
    # the cut first: its CPU f32 proof runs beside the full-depth run
    for name, (tree, tree_arch) in ((f"{label}-2l", cut_layers(params, arch,
                                                               P8_PROOF_LAYERS)),
                                    (label, (params, arch))):
        fn = make_transcribe_fn(tree_arch, cfg, fast_mel=True, fast_gelu=True, device=dev)
        shapes: dict = {}
        calls: dict = {}
        t0 = time.perf_counter()
        with checked_kernel_calls(shapes, calls, mel=True) as held:
            counters = zero_launches()
            with torch.inference_mode():
                toks, lens = fn(tree, wav)
            toks, lens = toks.cpu(), lens.cpu()
            launches = read_launches(counters)
        check(toks.shape[0] == P11_H8_BATCH and bool((lens == 4 + NEW_TOKENS).all())
              and int(toks.max()) < arch.vocab_size,
              f"{name}: tokens {tuple(toks.shape)} or lengths {lens.tolist()}")
        log(f"phase11 {name}: held batch of {P11_H8_BATCH} in "
            f"{time.perf_counter() - t0:.2f} s; launches {json.dumps(launched(launches))}; "
            f"{held_summary(held, shapes)}")
        check_launches(name, launches, path, p8_exact(tree_arch, tree, P11_H8_BATCH, path))
        out[name] = {"launches": launches}
        if name == label:
            p11_entries(results, label, bases, launches, shapes, calls)
        else:
            proof = Background(lambda n=name, t=tree, a=tree_arch, k=toks: small_h8_proof(
                n, tree_to(t, "cpu", torch.float32), a, cfg, wav.cpu(), k))
            if head_dim > 256:
                out[f"{name}-replay"] = run_self_attention_replay(
                    dev, tree_arch, tree, name=f"{name}-replay", phase="phase11")
                out[f"{name}-f32-encode"] = run_f32_wide_encode(dev, tree_arch, wav,
                                                                f"{name}-f32-encode")
    out[f"{label}-2l"]["parted"] = proof.result()
    return out


@torch.inference_mode()
def run_f32_wide_encode(dev, arch, wav: torch.Tensor, name: str) -> dict:
    """The encoder of a dense f32 tree of `arch` (seeded; a head dim past
    256: the f32 WIDE body) on `wav`, each kernel call held against its
    plain version (`checked_kernel_calls(mel=True)`), the encoder states
    finite; launch counts exact: the log-mel once, the encoder attention once
    a layer in its f32, WIDE and f32 WIDE counters."""
    from openai_whisper_compression_tpu_torch.audio import features
    from openai_whisper_compression_tpu_torch.models.params import init_params
    from openai_whisper_compression_tpu_torch.models.whisper import encode

    params = init_params(arch, SEED, torch.float32, dev)
    t0 = time.perf_counter()
    with checked_kernel_calls({}, {}, mel=True) as held:   # shims `features.preprocess`
        counters = zero_launches()
        enc = encode(params, arch, features.preprocess(wav, arch.num_mel_bins), fast_gelu=True)
        torch.cuda.synchronize()
        launches = read_launches(counters)
    check(enc.shape == (wav.shape[0], arch.max_source_positions, arch.d_model)
          and enc.dtype == torch.float32 and bool(torch.isfinite(enc).all()),
          f"{name}: encoder states {tuple(enc.shape)} {enc.dtype}, or not finite")
    layers = arch.encoder_layers
    exact = {"log_mel_cuda": 1, "encoder_attention_f32": layers,
             "encoder_attention_wide_dh": layers, "encoder_attention_f32_wide_dh": layers}
    check_launches(name, launches, set(exact), exact)
    log(f"phase11 {name}: {wav.shape[0]} clips held in {time.perf_counter() - t0:.2f} s; "
        f"launches {json.dumps(launched(launches))}; {held_summary(held, {})}")
    return {"launches": launches}


@torch.inference_mode()
def small_h8_proof(name: str, params_cpu, arch, cfg, wav: torch.Tensor,
                   toks: torch.Tensor) -> int:
    """The first REF_ROWS rows of a decode on the card against the same
    tree's CPU f32 decode (the same frontend and GELU): equal, or parted at a
    tie proven there; returns the rows that parted."""
    from openai_whisper_compression_tpu_torch.evaluation.harness import make_transcribe_fn

    t0 = time.perf_counter()
    fn = make_transcribe_fn(arch, cfg, fast_mel=True, fast_gelu=True, device="cpu")
    want, _ = fn(params_cpu, wav[:REF_ROWS])
    parted = check_ties(f"phase11 {name} card vs CPU f32", params_cpu, arch, cfg,
                        wav[:REF_ROWS], toks[:REF_ROWS], want, 4)
    log(f"phase11 {name}: {REF_ROWS - parted} of {REF_ROWS} rows equal CPU f32, "
        f"{parted} part at a tie proven there ({time.perf_counter() - t0:.1f} s)")
    return parted


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile one batch of each of the " + ", ".join(PROFILED)
                         + " runs with torch.profiler")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from openai_whisper_compression_tpu_torch.ops import kernels

    # f32 references run in full f32 on the card, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"phase0 {smi}")
    log(f"phase0 torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t0 = t_start = time.perf_counter()
    kernels.lib()
    log(f"phase0 kernel library {kernels.library_path().name}: ready in "
        f"{time.perf_counter() - t0:.2f} s (nvcc build "
        f"{kernels.build_seconds if kernels.build_seconds is not None else 'cached'} s)")

    results: dict = {}
    t_run = t_phase = time.perf_counter()

    def phase_done(what: str) -> None:
        nonlocal t_phase
        now = time.perf_counter()
        log(f"{what}: {now - t_phase:.1f} s (run so far {now - t_run:.1f} s)")
        t_phase = now

    phase1(dev, results)
    phase1_quantized(dev, results)
    phase1_4bit(dev, results)
    phase1_attention(dev, results)
    torch.cuda.empty_cache()
    phase1_w8a8(dev, results)
    phase1_small_batch(dev, results)
    phase1_dtypes(dev, results)
    phase1_crossover(dev)
    torch.cuda.empty_cache()
    phase1_head_dims(dev, results)
    phase1_limits(dev, results)
    phase_done("phase1")
    built: dict = {}
    build_s: dict = {}

    def params_for(arch_name: str, method: str):
        if (arch_name, method) not in built:
            t0 = time.perf_counter()
            built[arch_name, method] = make_params(dev, arch_name, method)
            torch.cuda.synchronize()
            build_s[arch_name, method] = time.perf_counter() - t0
        return built[arch_name, method]

    summaries = {}
    for run in RUNS:
        name, arch_name, method = run[:3]
        summaries[name] = run_path(dev, *params_for(arch_name, method), run,
                                   args.profile and name in PROFILED)
        if name in ("int8-kv", "medium-int4"):    # bench.py --presets' rows (phase 7)
            from openai_whisper_compression_tpu_torch.prune.flops import model_gflops

            steady = summaries[name]["walls_s"][1:3]
            summaries[name].update(
                ms_per_batch=1e3 * sum(steady) / len(steady),
                build_s=build_s[arch_name, method],
                gflops=model_gflops(built[arch_name, method][1], built[arch_name, method][0]))
        if arch_name != ARCH:
            del built[arch_name, method]
            torch.cuda.empty_cache()
    for run in PROMPT_RUNS:
        summaries[run[0]] = run_prompt_path(
            dev, *params_for(ARCH, (*run, "int8")[3]), run, args.profile and run[0] in PROFILED)
    summaries["self-attn-replay"] = run_self_attention_replay(
        dev, *params_for(ARCH, "int8"))
    phase_done("phase2")
    phase3(dev, params_for)
    phase_done("phase3 (its CPU f32 side queued)")
    # the slice-11 runs with no other tree resident, so that the
    # evaluation's peak memory is its own
    for key in [k for k in built if k != (ARCH, "int8")]:
        del built[key]
    torch.cuda.empty_cache()
    small_int8 = params_for(ARCH, "int8")
    summaries["eval-headline"] = run_eval_headline(dev, *small_int8)
    summaries["forward-small"] = run_forward_small(dev, *small_int8)
    summaries["unfused-int8"] = run_unfused_int8(dev, *small_int8)
    summaries.update(run_merge_pool(dev, *small_int8, results))
    summaries["fallback"] = run_fallback(dev, *small_int8)
    phase_done("phase4")
    # the slice-12 runs, again with no other tree resident
    torch.cuda.empty_cache()
    summaries.update(phase5(dev, *small_int8, results))
    phase_done("phase5")
    # the presets' timed runs; their held part runs inside phase 6, beside
    # the queued CPU proofs
    torch.cuda.empty_cache()
    p7 = phase7_timed(dev, summaries)
    phase_done("phase7 timed part")
    # the slice-15 runs; their CPU f32 proofs join the queue that runs
    # inside phase 6
    torch.cuda.empty_cache()
    summaries.update(phase8(dev, results))
    phase_done("phase8")
    # the slice-16 runs: storage, checkpoint conversion, the sweeps
    torch.cuda.empty_cache()
    summaries.update(phase9(dev, *small_int8, results))
    phase_done("phase9")
    rows, p11 = {}, {}

    def beside_proofs():   # card work while the queued CPU proofs run
        rows.update(phase7_held(dev, p7, results))
        torch.cuda.empty_cache()
        # phase 11's runs and then phase 10's (the CLI, DP and TP), all
        # held, nothing of them timed on the host; grad mode as at top
        # level (the held stream passes run under inference mode;
        # qat_recovery trains)
        with torch.inference_mode(False), torch.enable_grad():
            t1 = time.perf_counter()
            p11.update(phase11(dev, results))
            log(f"phase11 (beside the queued CPU proofs): {time.perf_counter() - t1:.1f} s")
            torch.cuda.empty_cache()
            t1 = time.perf_counter()
            p11.update(phase10(dev, small_int8[1], results))
            log(f"phase10 (beside the queued CPU proofs): {time.perf_counter() - t1:.1f} s")
            torch.cuda.empty_cache()

    p6_params, p6_arch = cut_layers(small_int8[1], small_int8[0], P6_LAYERS)
    summaries.update(phase6(dev, p6_arch, p6_params, results, between=beside_proofs))
    del p6_params
    summaries.update(p11)
    phase_done("phase6 (with phase 7's held part, phase 11 and phase 10)")
    check(not LATER, f"CPU proofs never run: {[label for label, _ in LATER]}")
    check(set(rows) == {"small_int8", "medium_int4_kv8"} | {r[0] for r in P7_RUNS},
          f"phase 7 rows: {sorted(rows)}")
    log("phase7 presets " + json.dumps(
        {k: {f: (round(v, 4) if isinstance(v, float) else v) for f, v in r.items()
             if f != "gflops"} | {"total_gflops": round(r["gflops"]["total_gflops"], 2)}
         for k, r in rows.items()}))
    del p7

    def launches(name):  # from the first run that launched the kernel
        return next(s["launches"][name] for s in summaries.values()
                    if s["launches"][name] > 0)

    kernels_line = {"kernels": [
        {"name": name, "route": "cuda", "source": CSRC + src,
         "replaces": JAX_PKG + rep, "launches": launches(name),
         **{k: results[key][k] for k in ("max_abs_err", "ms", "plain_ms",
                                          "bound_ms", "bound_by", "library_ms")}}
        for name, _, _, _, src, rep, key in KERNELS]}
    entries = {e["name"]: e for e in kernels_line["kernels"]}
    kernels_line["kernels"] += [
        {**entries[base], "name": name, "launches": summaries[run]["launches"][base],
         **{k: results[key][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms")}}
        for name, base, run, _, key in SHAPE_ENTRIES]
    kernels_line["kernels"] += [
        {**entries[base], "name": name,
         **{k: results[name][k] for k in ("launches", "max_abs_err", "ms", "plain_ms",
                                          "bound_ms", "bound_by", "library_ms")}}
        for name, base, _, _ in P5_ENTRIES + P6_ENTRIES + P7_ENTRIES + P8_ENTRIES
        + P9_ENTRIES]
    kernels_line["kernels"] += [
        {**entries[base], "name": name,
         **{k: results[name][k] for k in ("launches", "max_abs_err", "ms", "plain_ms",
                                          "bound_ms", "bound_by", "library_ms")}}
        for name, base, _ in P10_ENTRIES]
    kernels_line["kernels"] += [
        {**entries[r["base"]], "name": name,
         **{k: r[k] for k in ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                               "bound_by", "library_ms")}}
        for name, r in results.items()
        if any(f"@{label}-" in name for label in ("test2l", "small-h8", "small-h2"))]
    log(f"whole run: {time.perf_counter() - t_start:.1f} s, the build included "
        f"(phases {time.perf_counter() - t_run:.1f} s)")
    print(smi)
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
