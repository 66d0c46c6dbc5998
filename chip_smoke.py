#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / H100 port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and nvcc; exits non-zero, printing no result, without
them or outside a checkout of the repository.  Phases, in order, every
failure fatal:

  1. card name and power limit (nvidia-smi); build every ``csrc/*.cu``
     (one nvcc per source, all started together).  Deterministic
     algorithms are on for the whole run.
  2. every kernel against its plain PyTorch version on the card, bit-exact
     (float outputs compared as integer bits, so NaN and -0.0 count), at
     the serving, training and pipeline shapes and edge cases (the
     training cut's kernels also at batch 256, on a fallback tile wider
     than 2048, and on the cut holding a NaN, a +inf and a -inf; the
     TopK select also on a pipeline microbatch, ties across its chunks,
     zeros and -0.0, and every gradient leaf of a DP lane as (1, n) f32,
     timed at the serving shapes, the microbatch, the two largest leaves
     and the whole lane; the q8 wire quantizer at a full-width
     microbatch in bf16 and f32, a 256-row microbatch (a (256, 2048)
     tile, read twice) and a NaN of its own payload bits in the first
     and the last block of a tile's cluster (the meta keeps those bits;
     a NaN tile's codes 0); framing of
     the q4, q8-tiled, TopK and EF-mixed payloads of one and of odd-sized
     leaves, and of the 39-segment q8 / q4, the 26-segment TopK and the
     13-segment raw DP gradient payloads, one launch a call; the DP
     decode + sum at dp 1, 3 and 4, q8 and q4, on the full-width
     gpt2-small gradient payload and on a ragged tree with misaligned
     meta and a constant leaf, also against the unfused loop); then, at
     the main paths' shapes, device time per call (torch.profiler) of the
     kernel, of its plain version and of the one torch call computing the
     same function, beside the bytes-or-operations bound, with the device
     ops a call (a row whose profiles lost records is printed as LOST):
     the cut's kernels in bf16 and f32; the q8 wire quantizer at the
     pipeline hop in bf16 and f32; the q4 pack pair at serving
     prefill and decode, at the pipeline hop with the codec's expanded
     per-tensor pair (one device op a call), on each distinct gradient
     leaf size and over a whole DP lane (13 leaves in turn, one row;
     checked bit-exact on every leaf, the hop and its edge cases: odd n
     and h, views at element and byte offsets 1-3, many short rows, exact
     ties, NaN and +-inf, constant rows), the decode at dp = 4 on the q8
     and q4 payloads, and the framing pair on the four DP payloads as
     well as at their serving and pipeline shapes.  At phase 10's shapes
     (``tp_kernels``): bit-exact ``quantize_wire`` and the q4 pair at
     pipeline x TP's (8, 49,152) hop, the q4 pair on the tensor wire's
     (1, 393,216) and (1, 196,608) f32 rows and the select on the
     latter, framing of each of those payloads, and the decode at dp = 2
     on one tensor coordinate's block of the DP x TP stack (q8, q4) and
     one (stage column, tensor coordinate) block of the 3D stack; timed:
     the tensor rows' q4 pair and select, the DP x TP q8 decode.
  3. serve full-width gpt2-small (random weights from a seeded generator)
     with ``ServeEngine`` under the policies none, q4q8 and top10, launch
     counters set to 0 just before and read just after: each compressed
     policy must launch its kernels, and the plain backend on the card
     must give the same tokens.  The smoke model's prefill logits on the
     card must agree with the CPU path's (which the CPU tests hold to the
     JAX package).  Prefill / decode tokens/s from ``throughput_probe``.
  4. train full-width gpt2-small through the simulated stage cuts (batch
     8, seq 128, 4 stages, the launch/train AdamW) for 4 steps under
     none, q4q8, top10, top10reuse and AQ-SGD, launch counters set to 0
     just before and read just after: exact launches per step, finite
     and falling losses, the same losses under the plain backend; eval
     with compression on and off; one step of the smoke model on the
     card against the CPU; tokens/s and a profile of one step per policy.
  5. train full-width gpt2-small through the real compressed pipeline
     (batch 32, seq 128, 4 stages of 3 layer groups, 4 microbatches of 8,
     the launch/train AdamW) for 3 steps: gpipe under none, q4q8, top10,
     top10reuse, ef21top10 and AQ-SGD (64 samples: step 3 revisits step
     1's buffer rows), 1f1b under q4q8 and AQ-SGD, interleaved (2 stages x
     2 virtual) under q4q8; launch counters set to 0 just before and read
     just after.  Holds exact launches per step (12 hops per direction),
     the bytes counted at the hops == ``wire_telemetry`` x hops, 1f1b ==
     gpipe bitwise (losses and params), the same losses under the plain
     backend, falling losses, and the smoke model's pipeline step on the
     card against the CPU; tokens/s per run and a profile of one step per
     schedule.
  6. train full-width gpt2-small data-parallel on the simulated transport
     (dp = 4 lanes of 8, global batch 32, seq 128, 4 stages, the
     launch/train AdamW) for 3 steps with the compressed gradient
     all-reduce, as (DP codec, DP feedback, cut policy): (none, none,
     q4q8), (q8, none, q4q8), (q4, none, q4q8), (q8, ef, q4q8), (q4, ef21,
     q4q8), (topk 0.1, none, q4q8) and (q8, none, AQ-SGD + TopK 10%) with
     ``synthetic_stream(dp=4)``'s ids; launch counters set to 0 just before
     and read just after.  Holds exact launches per step (one
     ``decode_sum_fused`` per q8/q4 step, one framing launch a replica's
     payload), the ring's bytes ==
     ``dp_wire_report`` x dp(dp-1) hops, falling losses, the same losses
     under the plain backend, and the smoke model's DP step on the card
     against the CPU; tokens/s and the reduce's share of the step (CUDA
     events) per run, a profile of one step.
  7. the paper's CNN experiment on the card (launch counters set to 0
     just before and read just after): ResNet18 (width 64, 2 blocks a
     stage, 4 stages, 3 cuts of (100, 65,536), (100, 32,768) and (100,
     16,384) f32) on ``ImageClassData()``, batch 100, the reference's
     default SGD, 4 simulated-cut steps under none, q4q8, top10, EF21 and
     AQ-SGD (exact launches per step, finite losses, images/s; that SGD
     raises a full-width ResNet18's loss over its first steps, so no
     falling check); the homogeneous pipeline CNN (width 64, 4
     stages of 2 blocks, batch 128 as 4 microbatches of 32) 3 steps under
     gpipe q4q8, gpipe top10 and 1f1b q4q8 (exact launches and wire bytes
     == ``wire_telemetry`` x hops per step, 1f1b == gpipe bitwise); the
     top10 model evaluated on the 500 test images with compression on (3
     launches a batch) and off (0); ``run_cnn_experiment`` for 1 epoch
     per transport (acc_on, acc_off, seconds, exact launches); the same
     losses under the plain backend for every run; one step of a width-8
     CNN card vs CPU with the convs in TF32 (the default, which the line
     "# cnn precision" states) and in float32; a profile of one step per
     policy.  Phase 2 holds the cut kernels at the three cut shapes and
     the hop kernels at the (32, 65,536) f32 hop bit-exact and times them.
  8. the pipeline x DP step on the (data, stage) grid (launch counters
     set to 0 just before and read just after): full-width gpt2-small, 2
     replica rows x 4 stages (interleaved: 2 stages x 2 virtual), global
     batch 32 x 128, each row 16 as 4 microbatches of 4 (hops (4,
     98,304) bf16, 24 a direction a step), the launch/train AdamW, 3 steps
     under gpipe none + DP none, gpipe q4q8 + DP q8, gpipe EF21 TopK 10% +
     DP q4+EF21, 1f1b AQ-SGD TopK 10% + DP topk 0.1+EF and interleaved
     q4q8 + DP q8.  Holds exact launches per step (``pd_expected``), hop
     bytes == each row's ``wire_telemetry`` x hops x dp, the ring's bytes
     == S columns of ``dp_wire_report(shard_axis=S)`` x dp(dp-1), falling
     losses, the none run against the dp = 1 pipeline on the same batch
     as 8 microbatches of 4 (losses 1e-4 relative at step 1, 1e-3 after;
     step 1's gradient, the reduced stack's alone too, within
     ``PD_GRAD_REL`` of its norm), the same losses under the plain
     backend (q4q8 + DP q8), one smoke step card vs CPU under q4q8 + DP
     q8 and EF21 TopK + DP q4+EF21 (the loss, and the gradient the
     optimizer is given within ``PD_CPU_GRAD_RTOL``), and ``launch/train
     --mesh data=2,stage=4 --wire data=q8 --policy q4q8`` exiting 0;
     tokens/s per run and a profile of one step.  Phase 4 adds q4q8 with
     ``grad_accum=2`` (twice the cut launches a step), phase 6 q8 + q4q8
     with ``grad_accum=2`` a lane; phase 2 holds the decode + sum at dp =
     2 on one stage column's q8 / q4 payloads, and the q4 pair and the
     select at the (4, 98,304) hop, bit-exact, and times them (4 rows fill
     no (8, n) wire tile, so the q8 hop packs per tensor and launches no
     ``quantize_wire``).
  9. train state and rule policies, full-width gpt2-small, seed-0
     weights, the launch/train AdamW (launch counters set to 0 just before
     and read just after the in-process runs): four cases run 4 steps,
     then again 2 steps, ``save_train_state``, ``restore_train_state``
     into freshly initialised state and steps 3-4 (simulated cuts under
     AQ-SGD TopK 10%, batch 8 x 128; the pipeline, 1f1b EF21 TopK 10%, 4
     stages, 4 microbatches of 8; DP, 2 lanes of 8, q4 + EF21 around
     q4q8 cuts; pipeline x DP, 2 rows x 4 stages, gpipe EF21 TopK 10% +
     DP q4 + EF21): losses, final params, AdamW moments and step and every
     feedback buffer bitwise equal to the uninterrupted run's, exact
     launches every step, each file's bytes and save / restore seconds;
     the rule policy ``topk:0.1@depth<1, dir=fw;q4@dir=bw;q8`` on the
     simulated cuts (5 ``quant_dequant`` and 1 ``topk_block`` a step, the
     plain backend's losses), a one-rule q8 set bitwise equal to the
     static q8 policy, ``run_cnn_experiment`` (1 epoch) under
     ``topk:0.1@size>=65536;q4@size>=32768;q8`` (2 ``topk_block`` + 4
     ``quant_dequant`` a step, 1 + 2 a compressed test batch).  Six
     launcher subprocesses, each a fresh process, run in two waves beside
     those in-process runs: with the resumes, ``launch/train --steps 4``,
     the same run saving every 2 steps, and ``launch/train --mesh data=2
     --wire 'data=q4@size>=100000000;q8'`` and ``--wire data=q4``; with
     the rule policies (they read the first wave's files), ``--resume``
     from the step-2 file and ``launch/serve --engine static --ckpt`` on
     the step-4 train-state file.  The saving run's loss lines equal the
     uninterrupted run's, the resumed run's its steps 3-4, the rule-coded
     wire's those of ``--wire data=q4``, and the server exits 0; the
     launchers share the card, so no rate or second of theirs is
     printed, and the resumes' save / restore seconds are taken beside
     the first wave.  Every line carries the card's name and power limit.
 10. the tensor axis (launch counters set to 0 just before and read just
     after): full-width gpt2-small, seed-0 weights, the launch/train
     AdamW (cosine over 4 steps), every tensor rank a lane of the card, 3
     steps and a 4th, profiled (the card's activity only), under (a) TP
     alone, batch 8 x 128: tp 2 with the tensor wire none, q8, q8+EF and
     q4+EF21, tp 4 with TopK 10%; (b) DP x TP, 2 lanes of 8 x 128 x tp 2:
     DP q8 + tensor q8, DP q4+EF21 + tensor none; (c) pipeline x TP, 4
     stages x tp 2, 32 x 128 as 4 microbatches of 8 (each rank's hop (8,
     64, 768) bf16), gpipe and 1f1b, q4q8 cuts + tensor q4; (d) data 2 x
     stage 2 x tensor 2, 32 x 128 (rows of 16 as 4 microbatches of 4),
     gpipe, stage q8 + tensor q4 + DP q8.  Holds exact launches per step
     (``tp_expected``: 2 x 24 all-gathers and 2 x 24 reduce-scatters a
     run of the stack, tp and tp^2 packs each), ``tp_hops`` / ``tp_bytes``
     == ``tp_wire_report`` x ranks x 2 directions, the stage hops and the
     DP ring (one per (stage column, tensor coordinate)) against
     ``wire_telemetry`` and ``dp_wire_report(tp_axis=...)``, falling
     losses, 1f1b == gpipe bitwise, t2/none against the tp = 1 step
     (losses ``TP_REL_1`` / ``TP_REL_N`` relative, the step-1 gradient
     within ``TP_GRAD_REL``), the plain backend's losses bitwise for
     every lossy run (``TP_LOSSY``), and one smoke TP step card vs CPU
     under ``TP_CPU``'s
     bounds; tokens/s over steps 2-3 and the idle share per run.
 11. continuous serving (launch counters set to 0 just before and read
     just after): ``ContinuousEngine`` on full-width gpt2-small, seed-0
     weights, 4 stages, 4 slots, max_seq 256, 12 requests from the
     reference launcher's recipe (``zipf_lengths``: prompts 2-64, 1-16 new
     tokens, seeds 0-11): (a) slab, greedy, under none, q4q8 and top10;
     (b) sampled (T 0.8, top-k 40) under top10; (d) paged with prefix
     sharing (a 48-token shared prefix), 16-token chunks and pages, under
     top10; (e) speculative, spec_k 4, under q4q8, with the target's own
     params and a seed-1 model as draft.  Holds exact launches a drain
     (``cs_expected``: 3 cuts a forward), no page active and the page
     table's invariants after a paged drain, prefix hits; 8-tick chunks
     == single ticks, each request alone through the static engine (a
     companion prompt of its bucket's length pads it as the insert does)
     and speculative == paged greedy within the near-tie rule (a stream
     may part only where the reference stream's top-2 logits are within
     ``2 * LOGIT_ATOL``; every parting printed with its gap); the plain
     backend's tokens identical (slab, paged top10); sampled alone and
     twice identical; (c) EOS under q4q8: a request stops at its EOS
     token, the other streams are their greedy streams cut at it, and a
     slot freed while requests wait is refilled on the next tick; the
     uncompressed paged run against the slab on the same prompts (near
     ties); the cache's last row (warm-up at the 256 bucket, a slab
     request filling the cache beside a longer one, a paged prompt whose
     padded last chunk passes the last page; near-tie rule); (f)
     ``launch/serve --engine continuous`` in subprocesses (sampled, paged
     with a shared prefix, speculative, ``--ckpt`` of the seed-0 params),
     started after the profiled drains and run beside the checks above,
     which compare tokens only, each exiting 0 with every request served
     (they share the card, so their rates are not printed).  Every
     counted drain prints tok/s, mean TTFT and slot utilisation with the
     card's name and power limit, the phase its launches split into
     drains and warm-ups, and three profiled drains their idle share.
     Phase 2 holds the q4 pair and the select bit-exact at the per-token
     cut shapes (4, 768), (16, 768) and (20, 768) and times them
     (``cs_kernels``).
 12. telemetry (launch counters set to 0 just before and read just
     after), full-width gpt2-small, seed-0 weights, in this process
     through the launchers' ``main(argv)``: (a) ``launch/train --feedback
     aqsgd --k-frac 0.1 --steps 4 --batch 8 --seq 128`` without, with
     ``--trace --perfetto --metrics 2``, and without again: 4
     ``train.step`` spans, the quality tap's ``quality.boundary{0,1,2}``
     counters and ``quality.codec.*`` instants at steps 2 and 4 and
     ``quality.feedback_norms`` keyed ``[i]['fw'].resid``; launches exact
     (the run's, plus the tap's: 2 samples x the boundaries' compressing
     fw and bw compressors), the losses bitwise those of the untraced
     runs, the wall time of steps 2-4 of each run printed; (b)
     ``--mesh data=2,stage=4 --wire data=q8 --policy q4q8 --steps 2``
     (32 x 128, 4 microbatches) and (c) ``--mesh tensor=2 --wire tensor=q8
     --steps 2`` with ``--trace``: ``pipeline.wire`` / ``dp.wire`` /
     ``tp.wire`` twice each (the reference's count: the step's first
     input key, then its own outputs'), their args those of
     ``wire_telemetry``, ``dp_wire_report`` on the whole stack and
     ``tp_wire_report``; (d) ``launch/serve`` paged top10 with
     ``--prefix-cache --prefill-chunk 16 --shared-prefix 48 --trace
     --perfetto --metrics 2``: a ``serve.request_done`` per request after
     the warm-up, ``serve.sched`` / ``serve.pages`` on every tick of the
     every-2 grid, prefix hits, and the mean ``serve.prefill`` /
     ``serve.decode`` span of the served requests (the TTFT split); (e)
     ``run_lm_experiment`` 2 epochs of 2 steps of 8 x 128 under
     ``q8@bandwidth>=1e9;q4``, the probe giving the real ``probe_mesh(
     {"data": 4})`` reading before epoch 0 and a scripted 1e6 bytes/s
     before epoch 1: the policy curve [q8, q4], one ``policy.flip``,
     launches per epoch exact, and the probe's bytes/s printed as the
     card's one-hop copy rate.  Every JSONL passes ``validate_jsonl`` and
     every Chrome file loads with its ``traceEvents``.  Phase 2's
     library rows count the library call's launches from the profile's
     host side, and print ``LOST`` where its device records fall short.
 13. gemma2-27b and pixtral-12b at full width (launch counters set to 0
     just before and read just after), depth cut to 4 layers with
     ``dataclasses.replace``, seed-0 weights drawn on the card: gemma2
     (2 local/global groups, window 4,096, softcaps 50 / 30, post-norm,
     tied 256,000-row head; 1 cut) trains 3 steps of 1 x 8,192 tokens
     under none / q4q8 / top10, pixtral (3 cuts) 3 steps of 2 x 1,024
     with ``make_batch``'s zero patch embeddings under q4q8 / top10, each
     run as ``launch/train`` builds it, its params and AdamW moments
     donated (``make_lm_train_step(donate=True)``): "# big train" with
     losses, launches exact every step (2 / 6 cut kernels a step),
     tokens/s, ``max_memory_allocated`` and, for q4q8, a profiled 3rd
     step's busy time and idle share; gemma2 served by ``ServeEngine``
     (prompts of 4,100 and 300 tokens, 16 new: the local ring wraps)
     under none / q4q8 and by the slab ``ContinuousEngine`` (2 slots,
     max_seq 8,192, a 4,100-token bucket; local cache leaves of 4,096
     rows, global of 8,192; 3 requests; launches exact; streams against
     single ticks and against each request alone, near-tie rule), and
     ``prefix_cache=True`` refused; pixtral served statically under q4q8
     (2 x 512) and refused by ``ContinuousEngine``; then both smoke
     models on the card against the CPU (eval logits, a q4q8 step's loss
     and gradient, tests/test_torch_archs.py's bounds).  Phase 2 holds
     ``quant_dequant`` and ``topk_block`` bit-exact at the two cuts'
     (1, 8,192 x 4,608) and (2, 1,024 x 5,120) bf16 shapes and times
     them, and holds the q4 pair bit-exact at the q4q8 serving wire's
     rows with per-row statistics (gemma2's static prefill (2, 4,100 x
     4,608), a slab insert (1, 1,024 x 4,608) and decode (2, 4,608);
     pixtral's prefill (2, 512 x 5,120) and decode (2, 5,120)), timing
     the two prefills (``big_kernels``).
 14. Mixture-of-Experts (``models/moe.py``) at full width (launch
     counters set to 0 just before and read just after), depth cut with
     ``dataclasses.replace``, seed-0 weights drawn on the card (expert
     stacks an (in, out) slice at a time): mixtral-8x7b (2 of 32 layers,
     2 MoE groups, 8 experts top-2, window 4,096; 1 cut) trains 3 steps
     of 1 x 8,192 tokens (two routing groups of 4,096) under none / q4q8
     / top10 as phase 13 does ("# big train": losses, aux, step seconds,
     tokens/s, ``max_memory_allocated`` a step, launches exact, 2 cut
     kernels a compressing step; a profiled q4q8 step), is served by
     ``ServeEngine`` on prompts of 4,100 and 300 tokens under none / q4q8
     (the ring wraps; the MoE routes densely) and by the slab
     ``ContinuousEngine`` under q4q8 (phase 13's recipe), and the page
     pool and prefix cache refuse it with the reference's message;
     llama4-maverick-400b-a17b (4 of 48 layers, 2 (dense, MoE) groups,
     128 experts top-1 and a shared expert: 35.0 B parameters, 70.1 GB)
     is served by ``ServeEngine`` on prompts of 300 and 200 tokens and by
     the paged ``ContinuousEngine`` (a 256-token shared prefix, 3
     requests, 2 slots, chunks of 128) under q4q8, each with its
     ``max_memory_allocated``; then both smoke models on the card
     against the CPU on six seeds, their routing pinned
     (``RoutingReplay``: each parting a near-tie), eval logits and a
     q4q8 step's loss and gradient (tests/test_torch_archs.py's bounds)
     and its aux within 1e-2 of the CPU's.  Phase 2 holds
     ``quant_dequant`` and ``topk_block`` bit-exact at mixtral's cut
     (1, 8,192 x 4,096) bf16 and times them, and the q4 pair at every
     row shape phase 14 feeds it (mixtral's static prefill (2, 4,100 x
     4,096), its slab inserts (1, 512 | 1,024 | 4,100 x 4,096), the
     static prefills of its requests alone (2, 512 | 1,024 x 4,096), the
     decodes (2, 4,096); llama4's static prefill (2, 300 x 5,120), paged
     prefill chunk (128, 5,120) and decode (2, 5,120)), timing the long
     ones; phase 14 fails if it feeds the pair a row shape phase 2 did
     not check.
 15. linear attention (``models/linattn.py``) at full width (launch
     counters set to 0 just before and read just after), seed-0 weights
     drawn on the card: rwkv6-3b (d 2,560, 40 heads of 64, d_ff 8,960,
     vocab 65,536) and hymba-1.5b (d 1,600, 25 attention heads over 5 KV
     heads with window 1,024 beside 25 SSD heads of state 16, vocab
     32,001), each cut from 32 to 4 layers with ``dataclasses.replace`` (4
     groups, 3 cuts), train 3 steps of 1 x 4,096 tokens under none / q4q8
     / top10 as phase 13 does ("# big train": losses, step seconds,
     tokens/s, ``max_memory_allocated``, launches exact, 6 cut kernels a
     compressing step, a profiled q4q8 step's busy time and idle share);
     at full depth (32 layers) each is served by ``ServeEngine`` on two
     prompts of 1,100 tokens (a padded chunk; hymba's ring wraps) and 16
     new tokens under none / q4q8 ("# big serve", its peak memory) and
     refused by ``ContinuousEngine`` with the reference's message; then
     both smoke models on the card against the CPU (eval logits, a q4q8
     step's loss and gradient, tests/test_torch_archs.py's bounds, and
     greedy tokens served through the carried state, near-tie rule).
     Phase 2 holds ``quant_dequant`` and ``topk_block`` bit-exact at the
     two cuts (1, 4,096 x 2,560) and (1, 4,096 x 1,600) bf16 and times
     them, and the q4 pair at every row shape phase 15 feeds it (the
     static prefills (2, 1,100 x 2,560) and (2, 1,100 x 1,600), the
     decodes (2, 2,560) and (2, 1,600)), timing the prefills; phase 15
     fails if it feeds the pair a row shape phase 2 did not check.
 16. the encoder-decoder (``models/encdec.py``) through whisper-small at
     full width and depth (12 encoder and 12 decoder layers, d 768, 12
     heads of 64, d_ff 3,072, vocab 51,865, 1,500 frames; launch counters
     set to 0 just before and read just after), seed-0 weights drawn on
     the card: 3 steps of 8 x 448 decoder tokens against seeded N(0, 1)
     bf16 frame embeddings under none / q4q8 / top10 ("# big train", as
     phases 13-15: losses falling, 7 cut-kernel launches a compressing
     step (the memory hop's forward and 3 cuts both ways), step seconds,
     ``max_memory_allocated``, a profiled q4q8 step's idle share; "#
     whisper encoder gradient": the encoder's gradient non-zero at step
     1), 2 steps on 2 DP lanes with the q8 reduce and 2 with
     ``grad_accum=2``; the static engine on 4 prompts
     of 4 tokens, 64 new, under none / q4q8 / top10 (``throughput_probe``
     and ``generate``: launches exact, a mixed-length batch refused) and
     ``ContinuousEngine`` refused; the smoke model on the card against
     the CPU (eval logits, a q4q8 step's loss and gradient with the
     encoder's leaves, the greedy stream, near-tie rule) beside
     ``launch/train`` and ``launch/serve --arch whisper-small`` as
     concurrent subprocesses.  Phase 2 holds the cut kernels bit-exact at
     the memory hop (8 | 4, 1,500 x 768) and the decoder cut (8 | 4, 448
     x 768) bf16, the memory hop under autograd (``Compressor`` through
     ``quant_dequant_ad`` / ``topk_block_ad``, q4, q8 and top10 at (8 |
     4, 1,500 x 768) bf16 with a tied and a constant tile) forward and
     backward against the same calls on the CPU (``check_hop_ad``), the
     q4 pair and the select at the serving wire's rows
     (the memory per request (4, 1,152,000), the prefill (4, 3,072), a
     decode tick (4, 768)) and the DP q8 payload of whisper's 32 leaves
     decoded and summed at dp = 2, timing the long ones; phase 16 fails
     if it feeds a cut kernel, the q4 pair or the select a shape phase 2
     did not check.
 17. the tooling: ``launch/dryrun --all --policy q4q8``, started as a
     subprocess before phase 1 with no card in sight (it runs on the
     meta device), joined here: rc 0, last line ``# 40/40 OK``, its
     reports in ``chiprun_out/dryrun.json``.  The dry run held against
     the card (launch counters set to 0 just before and read just
     after) on ``TOOL_CONFIGS``: gpt2-small at full width and depth, 8 x
     1,024 tokens, q4q8 on the simulated cuts and on ``data=2,stage=2``
     with the q8 gradient ring and 2 pipeline microbatches, and glm4-9b
     at full width cut to 2 layers, 1 x 4,096, q4q8 simulated; each
     built by ``dryrun.train_case`` and run shape only and on the card
     (seed-0 weights): ``matmul_flops_global`` equal to FlopCounterMode's
     count of the card step, the 1 x 1 grid's ``argument_bytes`` equal
     to the card tree's ``nbytes``, and the wire record's bytes and ring
     launches (``collective_bytes`` / ``collective_counts(by_pairs)``)
     equal; every kernel call of these steps also run as its plain
     version on the same inputs, bit-exact (``checked_kernels``).  The
     four torch examples (``examples/*_torch.py``) on the card as
     concurrent subprocesses under the same check, their tables printed
     ("# example <name> | ..."), their launches added to the phase's.
 18. the pipeline's stages as processes (``pipeline_apply_rank``, the
     rank step of ``make_lm_train_step(group=)``): phase 5's runs
     gpipe/q4q8, gpipe/top10reuse and 1f1b/aqsgd on 4 ranks and
     interleaved/q4q8 on 2 (v = 2), full-width gpt2-small, 32 x 128 as 4
     microbatches, 3 steps, each rank a process started with
     ``torch.multiprocessing.spawn`` (the kernels built here, loaded
     there), the gloo backend, every rank on the one card and every
     payload staged through pinned host memory.  Each run held against
     phase 5's of the same name: step 1's loss bitwise, steps 2-3 within
     ``RANK_LOSS_RTOL`` (the clip's gathered norm), bytes and hops
     exactly, launches summed over the ranks exactly phase 5's, every
     rank's params, AdamW state and buffer rows on the card; "# ranks"
     lines with the step seconds and tokens/s beside phase 5's, "# ranks
     hop" with the staged hop's send and receive ms a direction;
     ``torch.distributed.run --nproc-per-node 2 -m repro_torch.launch.train
     --transport pipeline --stages 2 --dist-backend gloo --steps 2``
     printing the one-process launcher's loss lines; gpipe/q4q8 on nccl
     when the machine has 4 cards, else "# ranks nccl: not run".
 19. one ``{"kernels": [...]}`` line (launches summed over phases 3-18;
     the select kernels timed at the 38.6 M-element DP leaf), then the
     ``{"ok": true, ...}`` line.  Every number's line of phases 8-18
     carries the card's name and power limit.

Every profiled step of phases 3-11 records the card's activity only and
is read from the profiler's raw records (``device_records``): a host
trace of a train step takes seconds to minutes to read.
"""
from __future__ import annotations

import atexit
import contextlib
import json
import math
import os
import subprocess
import sys
import time
from collections import namedtuple
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12        # H100 SXM float32 rate outside the tensor cores
BATCH = 4
D_MODEL = 768                 # gpt2-small
PROMPT_LENS = (64, 17, 40, 5)  # mixed-length static batch, longest 64
NEW_TOKENS = 16
MAX_SEQ = 256
POLICY_KERNELS = {"none": (), "q4q8": ("pack4_wire", "unpack4_wire"),
                  "top10": ("topk_threshold", "topk_compact")}
LOGIT_ATOL = 0.03             # bf16 logits, card vs CPU (tests/test_torch_serve.py)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 128, 4
AQSGD_SAMPLES = 16            # steps 3-4 revisit the rows steps 1-2 wrote
# policy -> (launch/train --policy, --feedback), the kernel its cuts
# launch, launches per train step (3 cuts; top10reuse masks the gradient
# with the forward's exact TopK, so only its 3 forward cuts launch)
TRAIN_POLICIES = {"none": (("none", "none"), None, 0),
                  "q4q8": (("q4q8", "none"), "quant_dequant", 6),
                  "top10": (("top10", "none"), "topk_block", 6),
                  "top10reuse": (("top10reuse", "none"), "topk_block", 3),
                  "aqsgd": (("none", "aqsgd"), "topk_block", 6),
                  # grad_accum=2: the batch as 2 pieces of 4, each piece's
                  # cuts launching as a whole batch's do
                  "q4q8/accum2": (("q4q8", "none"), "quant_dequant", 12)}
LOSS_ATOL = 2e-3              # smoke-model loss, card vs CPU (tests/test_torch_train.py)
CUT_SHAPE = (TRAIN_BATCH, TRAIN_SEQ * D_MODEL)
KERNELS = {   # name -> (source, the TPU kernel it replaces)
    "topk_threshold": ("src/repro_torch/csrc/topk_select.cu",
                       "src/repro/kernels/topk_select.py:58"),
    "topk_compact": ("src/repro_torch/csrc/topk_select.cu",
                     "src/repro/kernels/topk_select.py:68"),
    "pack4_wire": ("src/repro_torch/csrc/pack4.cu",
                   "src/repro/kernels/pack4.py:82"),
    "unpack4_wire": ("src/repro_torch/csrc/pack4.cu",
                     "src/repro/kernels/pack4.py:107"),
    "quant_dequant": ("src/repro_torch/csrc/quantize.cu",
                      "src/repro/kernels/quantize.py:58"),
    "topk_block": ("src/repro_torch/csrc/topk_mask.cu",
                   "src/repro/kernels/topk_mask.py:55"),
    "quantize_wire": ("src/repro_torch/csrc/quantize.cu",
                      "src/repro/kernels/quantize.py:80"),
    "frame_parts": ("src/repro_torch/csrc/framing.cu",
                    "src/repro/kernels/framing.py:61"),
    "unframe_parts": ("src/repro_torch/csrc/framing.cu",
                      "src/repro/kernels/framing.py:84"),
    "decode_sum_fused": ("src/repro_torch/csrc/dp_reduce.cu",
                         "src/repro/kernels/dp_reduce.py:148"),
}
SERVE_KERNELS = ("topk_threshold", "topk_compact", "pack4_wire",
                 "unpack4_wire")
SELECT_KERNELS = ("topk_threshold", "topk_compact")
TRAIN_KERNELS = ("quant_dequant", "topk_block")
WIRE_KERNELS = ("quantize_wire", "frame_parts", "unframe_parts")
# the pipeline phase: 4 stages, 4 microbatches of 8 -> 12 hops per
# direction per step (interleaved: 2 stages x 2 virtual, 3 cuts each)
PIPE_BATCH, PIPE_SEQ, PIPE_STEPS, PIPE_MB, PIPE_STAGES = 32, 128, 3, 4, 4
PIPE_SAMPLES = 64             # AQ-SGD: step 3 revisits step 1's rows
PIPE_HOPS = 12
MB_SHAPE = (PIPE_BATCH // PIPE_MB, PIPE_SEQ, D_MODEL)
# bytes of one full-width microbatch's payload
PAYLOAD_BYTES = {"q4": 393224, "q8_tiled": 786816, "top10": 471840,
                 "top10_values": 157280, "none": 1572864}
LM_LOSS_ATOL = 0.02           # compressed smoke loss (tests/test_torch_pipeline.py)


def _per_step(**launches):
    """Expected launches per train step: every kernel 0 but these."""
    return {k: launches.get(k, 0) for k in KERNELS}


_Q4Q8 = dict(pack4_wire=PIPE_HOPS, unpack4_wire=PIPE_HOPS,
             quantize_wire=PIPE_HOPS)
_FRAMED = dict(frame_parts=2 * PIPE_HOPS, unframe_parts=2 * PIPE_HOPS)
_TOPK = dict(topk_threshold=2 * PIPE_HOPS, topk_compact=2 * PIPE_HOPS)
# run -> (launch/train --policy, --feedback, schedule, virtual stages,
#         launches per step, (fw, bw) payload bytes of one microbatch)
PIPE_RUNS = {
    "gpipe/none": ("none", "none", "gpipe", 1, _per_step(),
                   ("none", "none")),
    "gpipe/q4q8": ("q4q8", "none", "gpipe", 1, _per_step(**_Q4Q8),
                   ("q4", "q8_tiled")),
    "gpipe/top10": ("top10", "none", "gpipe", 1, _per_step(**_TOPK),
                    ("top10", "top10")),
    "gpipe/top10reuse": ("top10reuse", "none", "gpipe", 1,
                         _per_step(topk_threshold=PIPE_HOPS,
                                   topk_compact=PIPE_HOPS),
                         ("top10", "top10_values")),
    "gpipe/ef21top10": ("ef21top10", "none", "gpipe", 1,
                        _per_step(**_TOPK), ("top10", "top10")),
    "gpipe/aqsgd": ("none", "aqsgd", "gpipe", 1, _per_step(**_TOPK),
                    ("top10", "top10")),
    "1f1b/q4q8": ("q4q8", "none", "1f1b", 1,
                  _per_step(**_Q4Q8, **_FRAMED), ("q4", "q8_tiled")),
    "1f1b/aqsgd": ("none", "aqsgd", "1f1b", 1,
                   _per_step(**_TOPK, **_FRAMED), ("top10", "top10")),
    "interleaved/q4q8": ("q4q8", "none", "interleaved", 2,
                         _per_step(**_Q4Q8, **_FRAMED), ("q4", "q8_tiled")),
}
MB_ROWS = (PIPE_BATCH // PIPE_MB, PIPE_SEQ * D_MODEL)
WIRE = f"pipeline microbatch {MB_ROWS} bf16"
WIRE32 = f"pipeline microbatch {MB_ROWS} f32"
FRAMED = "q8-tiled backward hop (786432 + 384 B)"
PREFILL = f"prefill ({BATCH}, {max(PROMPT_LENS)}*768)"
DECODE = f"decode ({BATCH}, 768)"
CUT = f"training cut ({TRAIN_BATCH}, {TRAIN_SEQ}*768) bf16"
CUT32 = f"training cut ({TRAIN_BATCH}, {TRAIN_SEQ}*768) f32"
# the TopK DP codec's largest gradient leaves: wte (50257 x 768) and an
# MLP stack (12 x 768 x 3072), one (1, n) f32 row each
SEL_LEAF_N, SEL_LEAF2_N = 38597376, 28311552
SEL_LEAF = f"DP leaf (1, {SEL_LEAF_N}) f32"
SEL_LEAF2 = f"DP leaf (1, {SEL_LEAF2_N}) f32"
SEL_LANE = "DP lane: 13 leaves, each (1, n) f32"
HOP4 = f"pipeline hop {MB_ROWS} f32, the codec's expanded pair"

# the DP phase: 4 lanes of 8 (global batch 32), seq 128, 4 stages (3
# simulated cuts per lane), 13 parameter leaves, Sum n = 123,570,432
DP, DP_BATCH, DP_SEQ, DP_STEPS, DP_STAGES = 4, 32, 128, 3, 4
DP_SAMPLES = 64               # AQ-SGD: 16 rows a lane, step 3 revisits them
LEAVES = 13
# bytes of one replica's fused gradient buffer (one ring hop)
DP_PAYLOAD = {"q8": 123570536, "q4": 61785320, "topk": 74134592,
              "none": 247217664}
_DP = DP * LEAVES             # one pack / select per leaf and replica
_Q_RING = dict(frame_parts=DP, decode_sum_fused=1)   # 39 segments, 1 launch
# run -> (DP codec, DP feedback, k_frac, launch/train --policy,
#         --feedback, launches per step)
DP_RUNS = {
    "none/q4q8": ("none", "none", 0.1, "q4q8", "none",
                  _per_step(quant_dequant=6 * DP, frame_parts=DP,
                            unframe_parts=DP)),
    "q8/q4q8": ("q8", "none", 0.1, "q4q8", "none",
                _per_step(quant_dequant=6 * DP, **_Q_RING)),
    "q4/q4q8": ("q4", "none", 0.1, "q4q8", "none",
                _per_step(quant_dequant=6 * DP, pack4_wire=_DP, **_Q_RING)),
    "q8+ef/q4q8": ("q8", "ef", 0.1, "q4q8", "none",
                   _per_step(quant_dequant=6 * DP, **_Q_RING)),
    "q4+ef21/q4q8": ("q4", "ef21", 0.1, "q4q8", "none",
                     _per_step(quant_dequant=6 * DP, pack4_wire=_DP,
                               unpack4_wire=_DP, **_Q_RING)),
    "topk/q4q8": ("topk", "none", 0.1, "q4q8", "none",
                  _per_step(quant_dequant=6 * DP, topk_threshold=_DP,
                            topk_compact=_DP, frame_parts=DP,
                            unframe_parts=DP)),
    "q8/aqsgd": ("q8", "none", 0.1, "none", "aqsgd",
                 _per_step(topk_block=6 * DP, **_Q_RING)),
    # grad_accum=2 on each lane (2 pieces of 4), then one reduce
    "q8/q4q8/accum2": ("q8", "none", 0.1, "q4q8", "none",
                       _per_step(quant_dequant=12 * DP, **_Q_RING)),
}
DP_KERNELS = ("decode_sum_fused",)
DPQ8 = f"DP decode dp={DP} q8, full-width gpt2-small payload"
DPQ4 = f"DP decode dp={DP} q4, full-width gpt2-small payload"
DPF8 = f"q8 DP payload, 39 segments ({DP_PAYLOAD['q8']} B)"
DPF4 = f"q4 DP payload, 39 segments ({DP_PAYLOAD['q4']} B)"
DPFT = f"TopK DP payload, 26 segments ({DP_PAYLOAD['topk']} B)"
DPFN = f"raw DP payload, 13 segments ({DP_PAYLOAD['none']} B)"
# the CNN phase: ResNet18 (width 64, 2 blocks a stage, 4 stages, 3 cuts)
# on ImageClassData() (2000 train, 500 test 32x32 images), batch 100
CNN_WIDTH, CNN_BATCH, CNN_STEPS, CNN_TRAIN, CNN_TEST = 64, 100, 4, 2000, 500
CNN_CUT_LABELS = {(CNN_BATCH, 32 * 32 * CNN_WIDTH >> s):
                  f"CNN cut ({CNN_BATCH}, {32 * 32 * CNN_WIDTH >> s}) f32"
                  for s in range(3)}
# policy -> the kernel its cuts launch, launches per step (fw and bw at 3
# cuts; EF21 and AQ-SGD compress one message a direction)
CNN_POLICIES = {"none": (None, 0), "q4q8": ("quant_dequant", 6),
                "top10": ("topk_block", 6), "ef21": ("topk_block", 6),
                "aqsgd": ("topk_block", 6)}
# the homogeneous pipeline CNN: width 64, 4 stages of 2 blocks, batch 128
# as 4 microbatches of 32 -> 12 hops a direction a step, each (32, 32, 32,
# 64) f32
CNN_PIPE_BATCH, CNN_PIPE_MB, CNN_PIPE_STAGES, CNN_PIPE_STEPS = 128, 4, 4, 3
CNN_HOP = (CNN_PIPE_BATCH // CNN_PIPE_MB, 32 * 32 * CNN_WIDTH)
CNN_HOP_LABEL = f"CNN pipeline hop {CNN_HOP} f32"
CNN_FRAMED = "CNN q8-tiled backward hop (2097152 + 256 B)"
CNN_FRAMED4 = "CNN q4 forward hop (1048576 + 4 + 4 B)"
# the pipeline CNN's compressed eval runs the cut quantizer on a whole test
# batch of 128 (a (128, 2048) tile)
CNN_EVAL_CUT = (CNN_PIPE_BATCH, 32 * 32 * CNN_WIDTH)
CNN_EVAL_LABEL = f"CNN pipeline eval cut {CNN_EVAL_CUT} f32"
CNN_PAYLOAD = {"q4": 1048584, "q8_tiled": 2097408, "top10": 838912}
# run -> (launches per step, (fw, bw) payload of one microbatch)
CNN_PIPE_RUNS = {
    "gpipe/q4q8": (_per_step(**_Q4Q8), ("q4", "q8_tiled")),
    "gpipe/top10": (_per_step(**_TOPK), ("top10", "top10")),
    "1f1b/q4q8": (_per_step(**_Q4Q8, **_FRAMED), ("q4", "q8_tiled")),
}
# one smoke CNN step, card vs CPU: TF32 keeps 10 mantissa bits of each
# conv input (unit roundoff 2**-11); float32 convs differ from the CPU's
# only in summation order.  The loss and the updated params absolutely;
# the gradient as (the whole tree, each leaf) relative to its norm.  TF32
# leaves about 1% in the whole gradient and more in leaves whose sum
# cancels (a GroupNorm bias before the next GroupNorm); float32 holds
# every conv and GroupNorm backward leaf by leaf
CNN_TF32_ATOL, CNN_F32_ATOL = 2e-3, 1e-4
CNN_TF32_GRAD_RTOL, CNN_F32_GRAD_RTOL = (5e-2, 0.25), (1e-5, 1e-4)
# pipeline runs whose loss must fall over their steps: the reference's
# default SGD raises the loss of every other full-width run here over its
# first steps (tests/test_torch_cnn_train.py holds the port's first steps
# at width 32 to the reference's)
CNN_FALLING = ("gpipe/top10",)
# the pipeline x DP phase: 2 replica rows x 4 stages (interleaved: 2
# stages x 2 virtual), global batch 32 x 128, each row 16 as 4 microbatches
# of 4 -> a hop (4, 98,304) bf16, 12 hops a direction a row
PD_DP, PD_BATCH, PD_SEQ, PD_STEPS, PD_MB, PD_STAGES = 2, 32, 128, 3, 4, 4
PD_SAMPLES = 64               # AQ-SGD: 32 rows a replica, step 3 revisits
PD_HOPS = PD_DP * PD_MB * (PD_STAGES - 1)      # 24 a direction a step
PD_HOP = (PD_BATCH // (PD_DP * PD_MB), PD_SEQ * D_MODEL)
PD_HOP_LABEL = f"pipeline x DP hop {PD_HOP} bf16"
PD_HOP4_LABEL = f"pipeline x DP hop {PD_HOP} f32, the codec's expanded pair"
PD_COL8 = f"DP decode dp={PD_DP} q8, one stage column (3 layers)"
PD_COL4 = f"DP decode dp={PD_DP} q4, one stage column (3 layers)"
# run -> (launch/train --policy, --feedback, schedule, virtual stages,
#         DP codec, DP feedback, DP k_frac)
PD_RUNS = {
    "gpipe/none/none": ("none", "none", "gpipe", 1, "none", "none", 0.1),
    "gpipe/q4q8/q8": ("q4q8", "none", "gpipe", 1, "q8", "none", 0.1),
    "gpipe/ef21top10/q4+ef21": ("ef21top10", "none", "gpipe", 1, "q4",
                                "ef21", 0.1),
    "1f1b/aqsgd/topk+ef": ("none", "aqsgd", "1f1b", 1, "topk", "ef", 0.1),
    "interleaved/q4q8/q8": ("q4q8", "none", "interleaved", 2, "q8", "none",
                            0.1),
}
PD_REL_1, PD_REL_N = 1e-4, 1e-3   # (a) vs the dp = 1 pipeline: step 1, after
# |g - g_ref| / |g_ref| of the gradient the optimizer is given, over the
# whole tree and over the reduced layer stack alone.  A 1/dp slip of the
# stack's reduce gives 0.5 on the stack.  (a) vs the dp = 1 pipeline at
# step 1 (bf16 sums in another order; measured 3.3e-3 / 3.7e-3):
PD_GRAD_REL = 1e-2
# the smoke pipeline x DP step, card vs CPU, by cut policy: under q4q8
# (measured 0.022 / 0.028), and under EF21 TopK 10%, whose selection at
# the cut keeps other entries where the card's bf16 activations and the
# CPU's differ in a last bit (measured 0.20 / 0.30; the port and the JAX
# package part by up to 0.24 there, tests/test_torch_pipeline.py)
PD_CPU_GRAD_RTOL = {"q4q8": 0.1, "ef21top10": 0.4}
# the tensor axis phase: full-width gpt2-small with its layer stack over a
# tensor ring of tp ranks (lanes of the one card), seq 128, 3 steps and a
# 4th, profiled (the cosine spans 4); 24 all-gather (and 24 reduce-scatter)
# cut points a forward pass
TP_SEQ, TP_STEPS, TP_SITES = 128, 3, 24
TPRun = namedtuple(
    "TPRun", "dp dp_codec dp_fb stages stage_wire policy schedule tp "
             "tp_codec tp_fb batch mb")
TP_RUNS = {
    # (a) TP alone, batch 8 x 128
    "t2/none": TPRun(1, "none", "none", 1, "none", "none", "gpipe", 2,
                     "none", "none", 8, 1),
    "t2/q8": TPRun(1, "none", "none", 1, "none", "none", "gpipe", 2, "q8",
                   "none", 8, 1),
    "t2/q8+ef": TPRun(1, "none", "none", 1, "none", "none", "gpipe", 2,
                      "q8", "ef", 8, 1),
    "t2/q4+ef21": TPRun(1, "none", "none", 1, "none", "none", "gpipe", 2,
                        "q4", "ef21", 8, 1),
    "t4/topk": TPRun(1, "none", "none", 1, "none", "none", "gpipe", 4,
                     "topk", "none", 8, 1),
    # (b) DP x TP, 2 lanes of 8 x 128
    "d2t2/q8/q8": TPRun(2, "q8", "none", 1, "none", "none", "gpipe", 2,
                        "q8", "none", 16, 1),
    "d2t2/q4+ef21/none": TPRun(2, "q4", "ef21", 1, "none", "none", "gpipe",
                               2, "none", "none", 16, 1),
    # (c) pipeline x TP, 4 stages, 32 x 128 as 4 microbatches of 8: each
    # rank's hop (8, 64, 768) bf16
    "s4t2/gpipe/q4q8/q4": TPRun(1, "none", "none", 4, "none", "q4q8",
                                "gpipe", 2, "q4", "none", 32, 4),
    "s4t2/1f1b/q4q8/q4": TPRun(1, "none", "none", 4, "none", "q4q8",
                               "1f1b", 2, "q4", "none", 32, 4),
    # (d) data 2 x stage 2 x tensor 2, 32 x 128, rows of 16 as 4
    # microbatches of 4
    "d2s2t2/gpipe/q8/q4/q8": TPRun(2, "q8", "none", 2, "q8", "none",
                                   "gpipe", 2, "q4", "none", 32, 4),
}
# the runs held to the plain backend's losses bitwise: every run with a
# lossy wire (1f1b through its bitwise equality with gpipe)
TP_LOSSY = ("t2/q8", "t2/q8+ef", "t2/q4+ef21", "t4/topk", "d2t2/q8/q8",
            "d2t2/q4+ef21/none", "s4t2/gpipe/q4q8/q4",
            "d2s2t2/gpipe/q8/q4/q8")
# phase 2 at the tensor axis' shapes: a rank's (8, 64, 768) stage hop in
# pipeline x TP, and the tensor wire's shards and slices as
# pack_grad_leaf packs them, (1, n) f32: (8, 64, 768) at tp 2, (8, 32,
# 768) at tp 4 and 3D's (4, 64, 768)
TP_HOP = (8, 64 * D_MODEL)
TP_ROW2, TP_ROW4 = (1, 8 * 64 * D_MODEL), (1, 8 * 32 * D_MODEL)
TP_HOP_LABEL = f"pipeline x TP hop {TP_HOP}"
TP_ROW2_LABEL = f"tensor wire row {TP_ROW2} f32, the codec's pair"
TP_ROW4_LABEL = f"tensor wire row {TP_ROW4} f32"
TP_BLK8 = "DP decode dp=2 q8, one tensor coordinate of the DP x TP stack"
TP_BLK4 = "DP decode dp=2 q4, one tensor coordinate of the DP x TP stack"
TP_BLK3D = "DP decode dp=2 q8, one (stage column, tensor coordinate) block"
# t2/none against the tp = 1 step on the same batch: every sharded matmul
# group adds two bf16-rounded partial outputs where one device rounds
# once, 24 groups a pass.  Relative loss gap at step 1 / after, and the
# step-1 gradient the optimizer is given (tree and layer stack) relative
# to its norm
TP_REL_1, TP_REL_N, TP_GRAD_REL = 1e-3, 1e-2, 2e-2
# the smoke TP step (tp 2), card vs CPU: loss absolutely, the gradient
# relative to its norm, by tensor wire
TP_CPU = {"none": (LOSS_ATOL, 2e-2), "q8+ef": (LM_LOSS_ATOL, 0.1)}
# a ragged gradient tree: an odd leaf (misaligned meta), a rank-3 stack,
# a constant leaf (one code) and a leaf of 3 tiles and a bit
RAGGED = [(7,), (5, 33), (2, 3, 17), (6,), (3 * 8192 + 5,)]
# the continuous-serving phase: full-width gpt2-small, seed-0 weights, 4
# stages (3 cuts), 4 slots, max_seq 256; 12 requests from the reference
# launcher's recipe (``zipf_lengths``: prompts 2-64, max new tokens 1-16;
# the paged runs prepend a 48-token shared prefix), each request seeded
# with its index
CS_SLOTS, CS_MAX_SEQ, CS_REQUESTS = 4, 256, 12
CS_PROMPT, CS_NEW, CS_SHARED = 64, 16, 48
CS_CHUNK, CS_PAGE, CS_SPEC_K = 16, 16, 4
CS_SAMPLING = dict(temperature=0.8, top_k=40)
CS_POLICIES = ("none", "q4q8", "top10")
# phase 2 at phase 11's per-token cut shapes: one (1, 768) payload a row
CS_SHAPES = {f"decode tick ({CS_SLOTS}, 768)": CS_SLOTS,
             f"prefill chunk ({CS_CHUNK}, 768)": CS_CHUNK,
             f"verify span ({CS_SLOTS * (CS_SPEC_K + 1)}, 768)":
             CS_SLOTS * (CS_SPEC_K + 1)}


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def call_ms(torch, fn, iters=50, warm=True):
    """Per-call time of back-to-back calls, CUDA events (host included)."""
    if warm:
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


def device_events(prof):
    """(device ms, name) of every kernel / copy on the card in a profile.
    Only device-side events count: a CPU op's self device time repeats
    its kernels' (the rule of torch.profiler's own table total)."""
    from torch.autograd import DeviceType
    return [(ev.self_device_time_total / 1e3, ev.key)
            for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA]


def device_records(prof):
    """What :func:`device_events` gives, summed by name straight from the
    profiler's raw records: ``key_averages`` first builds the host-side
    event tree, which takes seconds on a train step's records."""
    from torch.autograd import DeviceType
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            by_name[e.name()] = by_name.get(e.name(), 0.0) + \
                e.duration_ns() / 1e6
    return [(ms, key) for key, ms in by_name.items()]


def record_counts(prof):
    """``{(name, on the card): (records, ms)}`` of a profile, straight
    from its raw records, as ``key_averages`` counts them (a device op's
    self time is its duration), without the schedule's step markers."""
    from torch.autograd import DeviceType
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("ProfilerStep"):
            continue
        key = (e.name(), e.device_type() == DeviceType.CUDA)
        count, ms = out.get(key, (0, 0.0))
        out[key] = (count + 1, ms + e.duration_ns() / 1e6)
    return out


# the host-side CUDA calls that each put one op on the card: what a library
# call launches, which no launch counter of the wrappers sees
HOST_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaLaunchCooperativeKernel",
                 "cudaMemcpyAsync", "cudaMemsetAsync")


def device_ms(torch, fn, kernel=None, iters=20, warm=True, profiles=1,
              host_launches=False):
    """Device time per call of everything ``fn`` launches (torch.profiler),
    of the kernels whose name contains ``kernel``, the number of device
    ops (kernels, copies, memsets) a call, and whether records were lost.
    Each device op's mean duration counts as many times as it runs a
    call: its records over ``iters``, rounded.  So a few lost or stray
    records change no count: late in a long run CUPTI has dropped the
    first records of a profile (14 of 20 calls seen, which divided by
    ``iters`` understated the time by 30%), and a warm-up cycle before the
    counted one, which makes that rarer, leaves one stray record in it.
    But CUPTI has also dropped most of an op's records (1 device op a
    call recorded of 4), which rounds the op away.  So the call is
    profiled ``profiles`` times and the profile with the most device ops
    a call is kept; while that is fewer than the wrapper launches a call
    (``_build.LAUNCHES``, counted over the profiled calls) it is profiled
    again, up to 3 more times, and is reported lost if still short.  A
    profile that sees no device time counts as short.  ``host_launches``:
    the launches a call makes are also counted from the profile's host
    side (``HOST_LAUNCHES`` a call), for a library call that no counter
    sees.  The counts and times come from the profile's raw records
    (:func:`record_counts`): ``key_averages`` first builds the host-side
    event tree, which takes seconds for a call of many ops.  Returns
    ``(ms, kernel ms, device ops a call, lost, launches a call)``."""
    from torch.profiler import ProfilerActivity, profile, schedule
    from repro_torch.kernels import _build
    if warm:
        fn()
    torch.cuda.synchronize()
    best, launched = None, 0
    for attempt in range(profiles + 3):
        before = sum(_build.LAUNCHES.values())
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        launched = max(launched, round((sum(_build.LAUNCHES.values())
                                        - before) / (2 * iters)))
        total = mine = 0.0
        ops = host = 0
        for (key, on_card), (count, dur) in record_counts(prof).items():
            runs = round(count / iters)
            if not on_card:
                if host_launches and key in HOST_LAUNCHES:
                    host += runs
                continue
            if not runs:
                continue
            ms = dur / count * runs
            total += ms
            mine += ms if kernel and kernel in key else 0.0
            ops += runs
        launched = max(launched, host)
        if total > 0 and (best is None or ops > best[2]):
            best = (total, mine, ops)
        if (attempt + 1 >= profiles and best is not None
                and best[2] >= launched):
            return best + (False, launched)
    if best is None:
        raise AssertionError(f"torch.profiler saw no device time in "
                             f"{profiles + 3} profiles")
    return best + (True, launched)


def bound_ms(nbytes, nops):
    """The larger of the bytes the function must move (each input read
    once, each output written once) over HBM's rate, and the float32
    operations it needs over the card's float32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_inputs(torch):
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(m, n):
        return torch.randn((m, n), generator=gen, device="cuda")

    ties = torch.randint(-3, 4, (BATCH, D_MODEL), generator=gen,
                         device="cuda").float()
    # zeros and -0.0 with a few values: the k-th magnitude is a zero
    zeros = torch.zeros((2, 20485), device="cuda")
    zeros[1, ::2] = -0.0
    zeros[:, ::997] = randn(2, 21)
    return {
        DECODE: randn(BATCH, D_MODEL),
        PREFILL: randn(BATCH, max(PROMPT_LENS) * D_MODEL),
        "prefill (1, 128*768)": randn(1, 128 * D_MODEL),
        "odd n (1, 767)": randn(1, 767),
        "constant (4, 768)": torch.full((BATCH, D_MODEL), 3.25,
                                        device="cuda"),
        "heavy ties (4, 768)": ties,
        "int32 index (2, 70001)": randn(2, 70001),
        "heavy ties, many chunks (8, 98304)": torch.randint(
            -3, 4, MB_ROWS, generator=gen, device="cuda").float(),
        "zeros and -0.0 (2, 20485)": zeros,
    }


def kernel_and_plain(torch, D, fn):
    D.KERNEL_BACKEND = "auto"
    got = fn()
    D.KERNEL_BACKEND = "plain"
    try:
        want = fn()
    finally:
        D.KERNEL_BACKEND = "auto"
    torch.cuda.synchronize()
    return got, want


def bits(torch, t):
    """A float tensor's bits as integers (``torch.equal`` fails on NaN and
    takes -0.0 for 0.0); any other tensor as it is."""
    if not t.is_floating_point():
        return t
    return t.view({8: torch.int64, 4: torch.int32,
                   2: torch.int16}[t.element_size()])


def max_err(torch, got, want):
    """0.0 when bit-exact; raises otherwise."""
    for a, b in zip(got, want):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{a.shape} {a.dtype} vs {b.shape} {b.dtype}")
        if not torch.equal(bits(torch, a), bits(torch, b)):
            d = (a.double() - b.double()).abs().max().item()
            raise AssertionError(f"kernel not bit-exact: max |diff| {d}")
    return 0.0


def check_select(torch, D, topk, x, k=None):
    """Both select kernels on ``x`` against their plain versions:
    bit-exact, exactly k indices per row, ascending."""
    m, n = x.shape
    k = select_k(n) if k is None else k
    t_k, t_p = kernel_and_plain(torch, D, lambda: topk.topk_threshold(x, k))
    max_err(torch, [t_k], [t_p])
    s_k, s_p = kernel_and_plain(torch, D,
                                lambda: topk.topk_compact(x, t_p, k))
    max_err(torch, s_k, s_p)
    idx = s_k[1]
    assert idx.shape == (m, k) and bool(
        (idx[:, 1:] > idx[:, :-1]).all()), "indices not ascending"


def select_inputs(torch, shapes):
    """The select's main-path tensors beyond serving: a pipeline
    microbatch (bf16, as its hops send it; also in f32) and one DP lane's
    13 gradient leaves of ``shapes``, each (1, n) f32 as
    ``pack_grad_leaf`` passes it."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    mb = torch.randn(MB_ROWS, generator=gen, device="cuda")
    lane = [torch.randn((1, math.prod(s)), generator=gen, device="cuda")
            * 0.01 for s in shapes]
    by_n = {x.shape[1]: x for x in lane}
    return {WIRE: [mb.to(torch.bfloat16)], WIRE32: [mb],
            SEL_LEAF: [by_n[SEL_LEAF_N]], SEL_LEAF2: [by_n[SEL_LEAF2_N]],
            SEL_LANE: lane}


def select_phase(torch, D, topk, inputs, shapes):
    """Phase 2's select part: both kernels bit-exact against their plain
    versions on the serving inputs (bf16 and f32), a pipeline microbatch
    and every gradient leaf of a DP lane, then timed at the serving
    prefill and decode, the microbatch, the two largest leaves and the
    whole lane.  Returns {label: {name: row}}."""
    for label, x32 in inputs.items():
        for dt in (torch.bfloat16, torch.float32):
            check_select(torch, D, topk, x32.to(dt))
        log(f"# select kernels bit-exact vs plain: {label}")
    sel = select_inputs(torch, shapes)
    for label, xs in sel.items():
        for x in xs:
            check_select(torch, D, topk, x)
        log(f"# select kernels bit-exact vs plain: {label}")
    sel[PREFILL] = [inputs[PREFILL].to(torch.bfloat16)]
    sel[DECODE] = [inputs[DECODE].to(torch.bfloat16)]
    timed = {}
    for label in (PREFILL, DECODE, WIRE, SEL_LEAF, SEL_LEAF2, SEL_LANE):
        timed[label] = time_select(torch, D, topk, sel[label])
        for name, row in timed[label].items():
            log(f"# {name} {label}: " + json.dumps(row))
    return timed


def check_kernels(torch, D, pack4, inputs):
    err = dict.fromkeys(SERVE_KERNELS, 0.0)
    for label, x32 in inputs.items():
        got = check_q4(torch, D, pack4, x32, *pack4.minmax_scale(x32))
        for name, e in zip(("pack4_wire", "unpack4_wire"), got):
            err[name] = max(err[name], e)
        log(f"# q4 kernels bit-exact vs plain: {label}")
    return err


def per_tensor_pair(pack4, x):
    """The codec's statistics of ``x`` (``transport/codecs.py``): one
    (min, scale) pair over the tensor, expanded over its rows (stride
    0)."""
    mn, sc = (v.reshape(()) for v in pack4.minmax_scale(x.reshape(1, -1)))
    return mn.expand(x.shape[0]), sc.expand(x.shape[0])


def time_pack4(torch, D, pack4, x32, per_tensor=False):
    """The q4 pair on one f32 tensor or a list of them (a DP lane's
    leaves, one call each in turn), with per-row statistics (serving) or
    the codec's expanded per-tensor pair (the pipeline hop, the DP
    leaves)."""
    xs = x32 if isinstance(x32, list) else [x32]
    stats = [per_tensor_pair(pack4, x) if per_tensor
             else pack4.minmax_scale(x) for x in xs]
    packed = [pack4.pack4_wire_plain(x, mn, sc)
              for x, (mn, sc) in zip(xs, stats)]
    elems = sum(x.numel() for x in xs)
    nbytes = sum(x.numel() * 4 + 8 * (1 if per_tensor else x.shape[0])
                 + p.numel() for x, p in zip(xs, packed))
    return time_cases(torch, D, {
        # (wrapper call, its CUDA kernel's name, library call or None,
        #  bytes the function moves, float32 operations it needs: the
        #  pack sub/div/round/clip and a shift-or per pair, the unpack a
        #  mul and an add)
        "pack4_wire": (lambda: [pack4.pack4_wire(x, mn, sc)
                                for x, (mn, sc) in zip(xs, stats)],
                       "pack4_kernel", None, nbytes, 6 * elems),
        "unpack4_wire": (lambda: [pack4.unpack4_wire(p, mn, sc, x.shape[1])
                                  for x, p, (mn, sc)
                                  in zip(xs, packed, stats)],
                         "unpack4_kernel", None, nbytes, 2 * elems),
    })


def q4_cases(torch, pack4):
    """The q4 pair's edge cases: label -> (x f32, min, scale, the packed
    bytes the unpack reads or None for the plain version's): odd n and odd
    h, x at element offsets 1-3 (rows 4-byte aligned), packed bytes at
    byte offsets 1-3, many short rows, exact ties (min 0, max 7.5, scale
    0.5: every odd element on a half-integer, the IEEE division's
    elements), NaN and +-inf with finite statistics and with their rows'
    own ((NaN, 1), (min, inf), (-inf, inf)), and constant rows."""
    gen = torch.Generator(device="cuda").manual_seed(11)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def own(x, packed=None):
        return (x, *pack4.minmax_scale(x), packed)
    cases = {f"n = {n} (5, {n})": own(randn(5, n)) for n in (1001, 1002)}
    for off in (1, 2, 3):
        x = randn(3 * 1001 + 3)[off:off + 3 * 1001].view(3, 1001)
        cases[f"x at element offset {off} (3, 1001)"] = own(x)
        y = randn(5, 2006)
        p = pack4.pack4_wire_plain(y, *pack4.minmax_scale(y)).reshape(-1)
        buf = torch.zeros(p.numel() + 3, dtype=torch.uint8, device="cuda")
        buf[off:off + p.numel()] = p
        cases[f"packed at byte offset {off} (5, 1003)"] = own(
            y, buf[off:off + p.numel()].view(5, 1003))
    cases["many short rows (4096, 33)"] = own(randn(4096, 33))
    j = torch.arange(8 * 4096 + 7, device="cuda") % 31
    cases["exact ties (3, 32775)"] = own(
        (j * 0.25).float().reshape(1, -1).repeat(3, 1))
    x = randn(6, 4101)
    x[0, 17] = x[4, 7] = float("nan")
    x[1, 4100] = x[3, 1000] = x[4, 8] = float("inf")
    x[2, 0] = x[3, 1001] = -float("inf")
    clean = torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)
    cases["NaN and +-inf, finite statistics (6, 4101)"] = (
        x, *pack4.minmax_scale(clean), None)
    cases["NaN and +-inf, their rows' statistics (6, 4101)"] = own(x)
    const = torch.full((4, 4099), 3.25, device="cuda")
    const[1] = -0.0
    cases["constant rows (4, 4099)"] = own(const)
    return cases


def check_q4(torch, D, pack4, x, mn, sc, packed=None):
    """Both q4 kernels against their plain versions, bit-exact (the
    unpacked floats as integer bits); ``packed`` (default: the plain
    version's bytes) is what the unpack reads.  Returns each kernel's
    max |error| (0.0; raises otherwise)."""
    p_k, p_p = kernel_and_plain(torch, D, lambda: pack4.pack4_wire(x, mn, sc))
    src = p_p if packed is None else packed
    u_k, u_p = kernel_and_plain(
        torch, D, lambda: pack4.unpack4_wire(src, mn, sc, x.shape[1]))
    return max_err(torch, [p_k], [p_p]), max_err(torch, [u_k], [u_p])


def q4_phase(torch, D, pack4, shapes):
    """Phase 2's q4 part beyond serving: the pair bit-exact on its edge
    cases, at the pipeline hop with the codec's expanded pair and on
    every gradient leaf of a DP lane ((1, n) f32, the expanded pair of
    one), then timed at the hop, at each distinct leaf size and over the
    whole lane.  Returns {label: {name: row}}."""
    for label, case in q4_cases(torch, pack4).items():
        check_q4(torch, D, pack4, *case)
        log(f"# q4 kernels bit-exact vs plain: {label}")
    gen = torch.Generator(device="cuda").manual_seed(8)
    hop = torch.randn(MB_ROWS, generator=gen, device="cuda")
    lane = [torch.randn((1, math.prod(s)), generator=gen, device="cuda")
            * 0.01 for s in shapes]
    for label, xs in ((HOP4, [hop]), (SEL_LANE, lane)):
        for x in xs:
            check_q4(torch, D, pack4, x, *per_tensor_pair(pack4, x))
        log(f"# q4 kernels bit-exact vs plain: {label}")
    timed = {HOP4: time_pack4(torch, D, pack4, hop, per_tensor=True)}
    by_n = {x.shape[1]: x for x in lane}
    for n, x in by_n.items():
        label = f"DP leaf (1, {n}) f32"
        timed[label] = time_pack4(torch, D, pack4, x, per_tensor=True)
        for row in timed[label].values():
            row["leaves"] = sum(x.shape[1] == n for x in lane)
    timed[SEL_LANE] = time_pack4(torch, D, pack4, lane, per_tensor=True)
    for label, rows in timed.items():
        for name, row in rows.items():
            log(f"# {name} {label}: " + json.dumps(row))
    return timed


def select_k(n):
    """k of a TopK 10% codec on a row of n (``topk_count(0.1, n)``)."""
    return max(1, int(round(0.1 * n)))


def time_select(torch, D, topk, xs):
    """``topk_threshold`` and ``topk_compact`` over the tensors ``xs``, one
    call each with k = 10% of a row, as the codecs call them (a list of
    (1, n) f32 leaves is one DP lane's select).  Bytes: each input read
    once, the (m, 1) f32 threshold, and the compaction's (m, k) values and
    int32 indices; operations: the threshold one compare per |x| as a
    one-pass select, the compaction two compares and a count.  The
    library yardstick is ``torch.topk`` on magnitudes computed beforehand
    (its values' last column for the threshold)."""
    ks = [select_k(x.shape[1]) for x in xs]
    threshs = [topk.topk_threshold_plain(x, k) for x, k in zip(xs, ks)]
    mags = [x.float().abs() for x in xs]
    read = sum(x.numel() * x.element_size() + 4 * x.shape[0] for x in xs)
    wrote = sum(x.shape[0] * k * (x.element_size() + 4)
                for x, k in zip(xs, ks))
    elems = sum(x.numel() for x in xs)
    return time_cases(torch, D, {
        "topk_threshold": (
            lambda: [topk.topk_threshold(x, k) for x, k in zip(xs, ks)],
            "topk_threshold",
            lambda: [torch.topk(g, k, dim=1).values[:, -1:]
                     for g, k in zip(mags, ks)], read, elems),
        "topk_compact": (
            lambda: [topk.topk_compact(x, t, k)
                     for x, t, k in zip(xs, threshs, ks)],
            "topk_compact",
            lambda: [torch.topk(g, k, dim=1) for g, k in zip(mags, ks)],
            read + wrote, 3 * elems),
    })


def time_cases(torch, D, cases):
    """name -> times and bound of each ``(wrapper call, the name its CUDA
    kernels contain, library call or None, bytes, float32 operations)``,
    the plain version's too.  Calls that take long (a plain version on a
    DP leaf or lane) are timed over fewer iterations."""
    rows = {}
    for name, (fn, kernel, lib, nbytes, nops) in cases.items():
        it = scaled_iters(torch, fn)
        row = dict(zip(("ms", "kernel_only_ms", "device_ops", "lost"),
                       device_ms(torch, fn, kernel, min(it, 20), warm=False,
                                 profiles=2)[:4]))
        row["call_ms"] = call_ms(torch, fn, it, warm=False)
        D.KERNEL_BACKEND = "plain"
        try:
            it = scaled_iters(torch, fn)
            row["plain_ms"], _, _, lost, _ = device_ms(
                torch, fn, iters=min(it, 20), warm=False)
            row["plain_call_ms"] = call_ms(torch, fn, min(it, 10), warm=False)
        finally:
            D.KERNEL_BACKEND = "auto"
        row["library_ms"] = None
        if lib is not None:
            # the library call's launches come from the profile's host
            # side: a profile that lost device records reads LOST (its
            # time kept apart), never a low time
            it = min(scaled_iters(torch, lib), 20)
            ms, _, ops, lost_lib, host = device_ms(
                torch, lib, iters=it, warm=False, profiles=2,
                host_launches=True)
            row.update(library_device_ops=ops, library_launches=host,
                       library_call_ms=call_ms(torch, lib, it, warm=False))
            if lost_lib:
                row["library_lost_ms"] = ms
            else:
                row["library_ms"] = ms
            lost = lost or lost_lib
        row["lost"] = row["lost"] or lost
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, nops)
        rows[name] = row
    return rows


def scaled_iters(torch, fn, most=50, budget_ms=300.0):
    """Warms ``fn`` up; ``most`` iterations, or as many as fit in
    ``budget_ms`` (at least 1) where one call takes long."""
    return max(1, min(most, int(budget_ms / max(call_ms(torch, fn, 1),
                                                1e-3))))


def cut_inputs(torch):
    """The training cut's tensors: its shape in bf16 and f32, a shorter
    sequence, m = 6 (row tile 2), batch 256 (a (256, 2048) tile), the
    whole-tensor fallback tiles (4, 767) and (2, 5001), a constant, a
    half-zero and a heavily tied tensor, and the cut with a NaN, a +inf
    and a -inf in three tiles, in bf16 and f32."""
    gen = torch.Generator(device="cuda").manual_seed(1)

    def randn(m, n):
        return torch.randn((m, n), generator=gen, device="cuda")

    x = randn(*CUT_SHAPE)
    zero_rows = randn(4, 4096)
    zero_rows[::2] = 0.0
    nonfinite = randn(*CUT_SHAPE)
    nonfinite[0, 5] = float("nan")
    nonfinite[4, 50000] = float("inf")
    nonfinite[7, 98301] = -float("inf")
    bf16 = torch.bfloat16
    return {
        CUT: x.to(bf16),
        CUT32: x,
        "NaN, +inf, -inf in the cut, bf16": nonfinite.to(bf16),
        "NaN, +inf, -inf in the cut, f32": nonfinite,
        "batch 256 (256, 4096) bf16": randn(256, 4096).to(bf16),
        "batch 256 (256, 4096) f32": randn(256, 4096),
        "fallback tile wider than 2048 (2, 5001) bf16":
            randn(2, 5001).to(bf16),
        "(4, 64*768) bf16": randn(4, 64 * D_MODEL).to(bf16),
        "m=6 (6, 4096) bf16": randn(6, 4096).to(bf16),
        "fallback tile (4, 767) bf16": randn(4, 767).to(bf16),
        "fallback tile (4, 767) f32": randn(4, 767),
        "constant (4, 4096) bf16": torch.full((4, 4096), 3.25, device="cuda",
                                              dtype=bf16),
        "all-zero rows (4, 4096) f32": zero_rows,
        "heavy ties (4, 4096) bf16": torch.randint(
            -3, 4, (4, 4096), generator=gen, device="cuda").to(bf16),
    }


def check_cut_kernels(torch, D, ops, inputs):
    """Both training-cut kernels, through the ops layer that picks the
    main path's tiles, against their plain versions: bit-exact."""
    err = dict.fromkeys(TRAIN_KERNELS, 0.0)
    for label, x in inputs.items():
        for bits in (4, 8):
            got, want = kernel_and_plain(
                torch, D, lambda: ops.quant_dequant_op(x, bits))
            err["quant_dequant"] = max(err["quant_dequant"],
                                       max_err(torch, [got], [want]))
        for k_frac in (0.1, 0.3):
            got, want = kernel_and_plain(
                torch, D, lambda: ops.topk_block_op(x, k_frac))
            err["topk_block"] = max(err["topk_block"],
                                    max_err(torch, [got], [want]))
        log(f"# cut kernels bit-exact vs plain: {label}")
    return err


def time_cut_kernels(torch, D, ops, x,
                     names=("quant_dequant", "topk_block")):
    """The training-cut kernels ``names`` (both by default) at the cut's
    shape (bf16 or f32).  Each
    function reads x once and writes its output once.  The quantizer
    needs about 9 float32 operations per element (min, max, sub, div,
    round, 2 clamps, mul, add), the TopK mask 3 (abs, compare, select):
    the threshold's select and bisection are the kernel's cost, not the
    function's.  The library
    yardstick of the TopK mask is the EXACT per-(row, tile) k-th largest
    magnitude (``ref.topk_exact_block_ref``'s threshold, not the
    bisection's bits) from ``torch.topk`` on precomputed magnitudes; the
    quantizer has no one-call equivalent."""
    from repro_torch.kernels.tiling import lane_block
    m, n = x.shape
    e = x.element_size()
    bn = lane_block(n) or n                     # the ops layer's tile
    k = math.ceil(0.1 * bn)
    mag = x.float().abs().view(m * n // bn, bn)
    cases = {
        "quant_dequant": (lambda: ops.quant_dequant_op(x, 4),
                          "quant_dequant_kernel", None, 2 * m * n * e,
                          9 * m * n),
        "topk_block": (lambda: ops.topk_block_op(x, 0.1),
                       "topk_block_kernel",
                       lambda: torch.topk(mag, k, dim=1).values[:, -1:],
                       2 * m * n * e, 3 * m * n),
    }
    return time_cases(torch, D, {name: cases[name] for name in names})


def wire_payload_parts(torch, codecs, x):
    """Flat uint8 leaf segments of the payloads a full-width microbatch
    ``x`` (bf16) sends through the pipeline's fused hops, and odd-sized
    leaves."""
    payloads = {
        "q4": codecs.get_codec("q4").pack(x),
        "q8-tiled": codecs.get_codec("q8").pack(x),
        "top10": codecs.get_codec("topk").pack(x, 0.1),
        "EF-mixed top10": {"x": codecs.get_codec("topk").pack(x, 0.05),
                           "e": codecs.get_codec("topk").pack(-x, 0.05)},
    }
    out = {name: [a.reshape(-1).view(torch.uint8)
                  for a in codecs.payload_leaves(pl)]
           for name, pl in payloads.items()}
    gen = torch.Generator(device="cuda").manual_seed(3)
    out["odd sizes"] = [torch.randint(0, 256, (nb,), generator=gen,
                                      device="cuda", dtype=torch.uint8)
                        for nb in (1, 7, 0, 33, 4097, 2, 16, 15)]
    whole = torch.randint(0, 256, (4098,), generator=gen, device="cuda",
                          dtype=torch.uint8)
    out["misaligned view"] = [whole[1:4097], whole[:5]]
    out["one segment"] = [whole[1:4097]]
    out["one segment and an empty one"] = [whole[:0], whole[:4097]]
    return out


def nan_payload_cases(torch, quantize, tiling, x):
    """The microbatch ``x`` (f32) with a NaN of its own payload bits in the
    first block of the first tile's cluster, in its last block, and one in
    each (the meta keeps the larger bit pattern as a signed integer), in
    bf16 and f32: label -> (tensor, its first tile's meta min's bits)."""
    block = tiling.wire_tiling(tuple(x.shape))
    cases = {}
    for dtype, ints, elem, pay in (
            (torch.float32, torch.int32, 4, (0x7FC00123, 0x7FC00456)),
            (torch.bfloat16, torch.int16, 2, (0x7FC1, 0x7FC3))):
        g = quantize.geometry(x.shape[1], *block, elem, True)
        row_units = block[1] // g.v
        # unit u of a tile is read by block (u // THREADS) % cluster
        at = [max(u for u in range(block[0] * row_units)
                  if u // quantize.THREADS % g.cluster == r) * g.v
              for r in (0, g.cluster - 1)]
        for name, spots in (("first block", [0]), ("last block", [1]),
                            ("both blocks", [0, 1])):
            t = x.to(dtype, copy=True)
            for k in spots:
                t.view(ints)[at[k] // block[1], at[k] % block[1]] = pay[k]
            cases[f"NaN payload, {name}, {MB_ROWS} {8 * elem}-bit"] = (
                t, pay[max(spots)] << 32 - 8 * elem)
    return cases


def check_wire_kernels(torch, D, quantize, framing, codecs, tiling):
    """The q8 wire quantizer and the framing pair against their plain
    versions: bit-exact (a NaN tile's codes, undefined in the plain
    version, are the kernel's 0)."""
    err = dict.fromkeys(WIRE_KERNELS, 0.0)
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(MB_ROWS, generator=gen, device="cuda")
    half = torch.randn((16, 4096), generator=gen, device="cuda")
    half[:, :2048] = 0.0
    cases = {
        f"{MB_ROWS} bf16": x.to(torch.bfloat16),
        f"{MB_ROWS} f32": x,
        "256-row microbatch (256, 98304) bf16": torch.randn(
            (256, 128 * D_MODEL), generator=gen,
            device="cuda").to(torch.bfloat16),
        "(16, 4096) f32": torch.randn((16, 4096), generator=gen,
                                      device="cuda"),
        "constant (8, 4096) bf16": torch.full((8, 4096), 3.25, device="cuda",
                                              dtype=torch.bfloat16),
        "half-zero tiles (16, 4096) f32": half,
    }
    for label, t in cases.items():
        block = tiling.wire_tiling(tuple(t.shape))
        got, want = kernel_and_plain(
            torch, D, lambda: quantize.quantize_wire(t, 8, block))
        err["quantize_wire"] = max(err["quantize_wire"],
                                   max_err(torch, got, want))
        log(f"# quantize_wire bit-exact vs plain: {label} tile {block}")
    del cases
    for label, (t, nan_bits) in nan_payload_cases(torch, quantize, tiling,
                                                  x).items():
        block = tiling.wire_tiling(tuple(t.shape))
        (codes, meta), (pcodes, pmeta) = kernel_and_plain(
            torch, D, lambda: quantize.quantize_wire(t, 8, block))
        max_err(torch, [meta], [pmeta])
        got = bits(torch, meta)[0, 0].item() & 0xFFFFFFFF
        if got != nan_bits or meta[0, 1].item() != 1.0:
            raise AssertionError(f"{label}: meta min bits {got:#x}, scale "
                                 f"{meta[0, 1].item()}; want {nan_bits:#x}, 1")
        defined = torch.ones_like(codes, dtype=torch.bool)
        defined[:, :block[1]] = False          # the NaN tile's codes
        max_err(torch, [codes[defined]], [pcodes[defined]])
        if codes[~defined].any():
            raise AssertionError(f"{label}: a NaN tile's code is not 0")
        log(f"# quantize_wire bit-exact vs plain: {label}, meta min "
            f"{got:#x}")
    xb = x.to(torch.bfloat16).reshape(MB_SHAPE)
    for label, parts in wire_payload_parts(torch, codecs, xb).items():
        sizes = [p.numel() for p in parts]
        got, want = kernel_and_plain(torch, D,
                                     lambda: framing.frame_parts(parts))
        err["frame_parts"] = max(err["frame_parts"],
                                 max_err(torch, [got], [torch.cat(parts)]))
        max_err(torch, [got], [want])
        segs, plain = kernel_and_plain(
            torch, D, lambda: framing.unframe_parts(want, sizes))
        err["unframe_parts"] = max(err["unframe_parts"],
                                   max_err(torch, segs, plain))
        max_err(torch, segs, [p.contiguous() for p in parts])
        log(f"# framing bit-exact vs plain: {label} {sizes}")
    idx = torch.randint(0, 1 << 16, (8, 300), generator=gen, device="cuda",
                        dtype=torch.int32).to(torch.uint16)
    seg = idx.reshape(-1).view(torch.uint8)
    back = framing.unframe_parts(framing.frame_parts([seg, seg[:6]]),
                                 [seg.numel(), 6])[0]
    assert torch.equal(back.view(torch.uint16).reshape(8, 300), idx)
    log("# uint16 index leaves view to and from uint8 on the card")
    return err


def time_wire_kernels(torch, D, quantize, framing, codecs, tiling):
    """The wire kernels at the pipeline's shapes: the q8 quantizer on a
    full-width microbatch in bf16 and in f32 (reads 2 or 4 B and writes 1
    B an element, plus the meta; about 7 float32 operations an element:
    min, max, sub, div, round, two clamps), the framing pair on the
    q8-tiled backward hop (each byte read once and written once).
    Library yardsticks: ``torch.cat`` frames,
    ``torch.split_with_sizes_copy`` unframes into fresh tensors; a
    per-tile quantizer has no one-call torch equivalent.  Returns
    {label: {name: row}}."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    x32 = torch.randn(MB_ROWS, generator=gen, device="cuda")
    x = x32.to(torch.bfloat16)
    return {WIRE: time_quantize_wire(torch, D, quantize, tiling, x),
            WIRE32: time_quantize_wire(torch, D, quantize, tiling, x32),
            FRAMED: time_hop_framing(torch, D, framing, codecs, x)}


def time_quantize_wire(torch, D, quantize, tiling, t):
    """The q8 wire quantizer on one hop tensor (its wire tile)."""
    m, n = t.shape
    block = tiling.wire_tiling((m, n))
    meta_bytes = 4 * 2 * (m // block[0]) * (n // block[1])
    rows = time_cases(torch, D, {
        "quantize_wire": (lambda: quantize.quantize_wire(t, 8, block),
                          "quantize_wire_kernel", None,
                          m * n * (t.element_size() + 1) + meta_bytes,
                          7 * m * n)})
    rows["quantize_wire"]["library"] = (
        "none: no one torch call quantizes per tile")
    return rows


def hop_payload_parts(torch, codecs, x, codec="q8"):
    """Flat uint8 leaf segments of ``codec``'s payload of hop tensor ``x``,
    as ``fuse_payload`` frames them."""
    return [a.reshape(-1).view(torch.uint8) for a in
            codecs.payload_leaves(codecs.get_codec(codec).pack(x))]


def time_hop_framing(torch, D, framing, codecs, x, codec="q8"):
    """The framing pair on ``codec``'s payload of hop tensor ``x`` (the
    q8-tiled one by default)."""
    parts = hop_payload_parts(torch, codecs, x, codec)
    buf = torch.cat(parts)
    rows = framing_cases(torch, D, framing, parts, buf,
                         [p.numel() for p in parts])
    rows["frame_parts"]["library"] = "torch.cat(parts)"
    rows["unframe_parts"]["library"] = ("torch.split_with_sizes_copy("
                                        "buf, sizes)")
    return rows


def gpt2_leaves(torch):
    """The 13 parameter leaf shapes of full-width gpt2-small, in
    ``tree_leaves`` order (Sum n = 123,570,432), and their dtypes (bf16,
    the layer norms' f32)."""
    from repro_torch.configs.registry import get
    from repro_torch.models import transformer
    from repro_torch.optim.optimizers import tree_leaves
    params = transformer.init_params(
        torch.Generator(device="cuda").manual_seed(0), get("gpt2-small"))
    shapes = [tuple(a.shape) for a in tree_leaves(params)]
    assert len(shapes) == LEAVES, shapes
    return shapes, [a.dtype for a in tree_leaves(params)]


def replica_payload(torch, codecs, collectives, codec, shapes, gen,
                    dtypes=None):
    """One replica's gradient payload, packed from seeded f32 gradients of
    ``shapes`` (cast to ``dtypes``, as the raw codec sends the leaves in
    their own dtype; leaf 3 of the ragged tree constant), and its flat
    uint8 leaf segments as the ring frames them."""
    c = codecs.get_codec(codec)
    payload = []
    for i, s in enumerate(shapes):
        g = torch.randn(s, generator=gen, device="cuda") * 0.01
        if shapes is RAGGED and i == 3:
            g = torch.full(s, 0.75, device="cuda")
        if dtypes is not None:
            g = g.to(dtypes[i])
        payload.append(collectives.pack_grad_leaf(c, g))
    return payload, [a.reshape(-1).view(torch.uint8)
                     for a in codecs.payload_leaves(payload)]


def dp_bank(torch, codecs, collectives, codec, shapes, seed, dp=DP):
    """(dp, nbytes) uint8 bank of ``dp`` replicas' fused gradient buffers,
    its decode plans, payload structs and the last replica's segments."""
    from repro_torch.kernels import dp_reduce
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for _ in range(dp):
        payload, leaves = replica_payload(torch, codecs, collectives, codec,
                                          shapes, gen)
        buf = codecs.fuse_payload(payload)
        if not torch.equal(buf, torch.cat(leaves)):
            raise AssertionError(f"{codec} DP payload: framing != torch.cat")
        rows.append(buf)
    structs = codecs.payload_struct(payload)
    plans = dp_reduce.build_decode_plans(structs, shapes)
    return torch.stack(rows), plans, structs, leaves


def check_dp_kernels(torch, D, codecs, collectives, framing, shapes,
                     dtypes):
    """The DP decode + sum against its plain version and against the
    unfused loop (unfuse -> unpack -> rank-ordered add), bit-exact, at
    dp 1, 3 and 4, on the full-width payload and the ragged tree; framing
    of the 39-segment q8 / q4 payloads, the 26-segment TopK and the
    13-segment raw payload against torch.cat and slices, one launch a
    call."""
    from repro_torch.kernels import _build, dp_reduce
    err = 0.0
    for label, leaf_shapes in (("full-width gpt2-small", shapes),
                               ("ragged", RAGGED)):
        for codec in ("q8", "q4"):
            bank, plans, structs, leaves = dp_bank(
                torch, codecs, collectives, codec, leaf_shapes, 5)
            if leaf_shapes is RAGGED:
                assert any(p.meta_off % 4 for p in plans), "meta aligned"
            sizes = [a.numel() for a in leaves]
            segs, plain = kernel_and_plain(
                torch, D, lambda: framing.unframe_parts(bank[-1], sizes))
            max_err(torch, segs, plain)
            max_err(torch, segs, leaves)
            c = codecs.get_codec(codec)
            for dp in (1, 3, 4):
                slots = bank[:dp]
                got, want = kernel_and_plain(
                    torch, D,
                    lambda: dp_reduce.decode_sum_fused(slots, plans, dp))
                err = max(err, max_err(torch, got, want))
                loop = [None] * len(leaf_shapes)
                for s in range(dp):
                    pls = codecs.unfuse_payload(slots[s], structs)
                    for i, shape in enumerate(leaf_shapes):
                        m = collectives.unpack_grad_leaf(c, pls[i], shape)
                        loop[i] = m if loop[i] is None else loop[i] + m
                max_err(torch, [a.reshape(l.shape) for a, l in
                                zip(got, loop)], loop)
                log(f"# decode_sum_fused bit-exact vs plain and the unfused "
                    f"loop: {label} {codec} dp={dp} ({len(sizes)} segments)")
            del bank, leaves
    gen = torch.Generator(device="cuda").manual_seed(9)
    for codec, segments in (("topk", 2 * LEAVES), ("none", LEAVES)):
        _, leaves = replica_payload(torch, codecs, collectives, codec,
                                    shapes, gen, dtypes)
        sizes = [a.numel() for a in leaves]
        assert len(sizes) == segments, sizes
        _build.reset_launches()
        buf = framing.frame_parts(leaves)
        segs = framing.unframe_parts(buf, sizes)
        torch.cuda.synchronize()
        if _build.LAUNCHES != {"frame_parts": 1, "unframe_parts": 1}:
            raise AssertionError(f"{codec} DP payload framed in "
                                 f"{_build.LAUNCHES} launches, not 1 each")
        max_err(torch, [buf], [torch.cat(leaves)])
        max_err(torch, segs, leaves)
        log(f"# framing bit-exact vs torch.cat and slices, one launch "
            f"each: {codec} DP payload ({segments} segments, {buf.numel()} B)")
        del leaves, buf, segs
    return {"decode_sum_fused": err}


def time_dp_kernels(torch, D, codecs, collectives, framing, shapes,
                    dtypes):
    """``decode_sum_fused`` at dp = 4 on the full-width payload.  The
    function reads each source's code bytes once (dp * nbytes, the meta
    included) and writes Sum n float32; 2 dp float32 operations an
    element (a multiply and an add per source).  No one torch call
    decodes and sums.  Also the framing pair on one replica's payload, as
    the ring frames and unframes it: the 39-segment q8 and q4 payloads
    (labels ``DPF8`` / ``DPF4``, unframed from the bank's row, 8 bytes off
    16-byte alignment), the 26-segment TopK (``DPFT``) and the 13-segment
    raw payload (``DPFN``)."""
    from repro_torch.kernels import dp_reduce
    rows = {}
    for label, flabel, codec in ((DPQ8, DPF8, "q8"), (DPQ4, DPF4, "q4")):
        bank, plans, _, leaves = dp_bank(torch, codecs, collectives, codec,
                                         shapes, 6)
        if bank.shape[1] != DP_PAYLOAD[codec]:
            raise AssertionError(f"{codec} DP payload {bank.shape[1]} B, "
                                 f"expected {DP_PAYLOAD[codec]}")
        total = sum(p.n for p in plans)
        rows[label] = time_cases(torch, D, {"decode_sum_fused": (
            lambda: dp_reduce.decode_sum_fused(bank, plans, DP),
            "decode_sum_kernel", None, DP * bank.shape[1] + 4 * total,
            2 * DP * total)})["decode_sum_fused"]
        rows[label]["shape"] = label
        rows[label]["library"] = "none: no one torch call decodes and sums"
        buf, sizes = bank[-1], [a.numel() for a in leaves]
        rows[flabel] = framing_cases(torch, D, framing, leaves, buf, sizes)
        del bank, buf, leaves
    gen = torch.Generator(device="cuda").manual_seed(10)
    for label, codec in ((DPFT, "topk"), (DPFN, "none")):
        _, leaves = replica_payload(torch, codecs, collectives, codec,
                                    shapes, gen, dtypes)
        buf, sizes = torch.cat(leaves), [a.numel() for a in leaves]
        if buf.numel() != DP_PAYLOAD[codec]:
            raise AssertionError(f"{codec} DP payload {buf.numel()} B, "
                                 f"expected {DP_PAYLOAD[codec]}")
        rows[label] = framing_cases(torch, D, framing, leaves, buf, sizes)
        del buf, leaves
    return rows


def framing_cases(torch, D, framing, leaves, buf, sizes):
    """The framing pair on one payload: each byte read once and written
    once, against ``torch.cat`` and ``torch.split_with_sizes_copy``."""
    return time_cases(torch, D, {
        "frame_parts": (lambda: framing.frame_parts(leaves),
                        "framing_kernel", lambda: torch.cat(leaves),
                        2 * buf.numel(), 0),
        "unframe_parts": (lambda: framing.unframe_parts(buf, sizes),
                          "framing_kernel",
                          lambda: torch.split_with_sizes_copy(buf, sizes),
                          2 * buf.numel(), 0)})


def pd_column_leaves(torch):
    """Leaf shapes of one stage column of full-width gpt2-small's layer
    stack (``stack_layer_stages`` into 4 slices, each column's 3 layers),
    as the pipeline x DP reduce packs them."""
    from repro_torch.configs.registry import get
    from repro_torch.models import transformer
    from repro_torch.optim.optimizers import tree_leaves
    params = transformer.init_params(
        torch.Generator(device="cuda").manual_seed(0), get("gpt2-small"))
    stack = transformer.stack_layer_stages(params, PD_STAGES)
    return [(a.shape[0] // PD_STAGES, *a.shape[1:])
            for a in tree_leaves(stack)]


def pd_kernels(torch, D, pack4, topk, codecs, collectives, tiling):
    """Phase 2 at the pipeline x DP path's new shapes: the decode + sum
    at dp = 2 on one stage column's q8 and q4 payloads (against its plain
    version and the unfused loop), and at the (4, 98,304) hop the q4 pair
    (f32, the codec's expanded pair) and the TopK select (bf16); every
    one bit-exact, then timed with its bound.  Returns ({kernel: max
    error}, {label: {name: row}})."""
    from repro_torch.kernels import dp_reduce
    err = dict.fromkeys(KERNELS, 0.0)
    timed = {}
    shapes = pd_column_leaves(torch)
    for label, codec in ((PD_COL8, "q8"), (PD_COL4, "q4")):
        bank, plans, structs, _ = dp_bank(torch, codecs, collectives, codec,
                                          shapes, 12, dp=PD_DP)
        got, want = kernel_and_plain(
            torch, D, lambda: dp_reduce.decode_sum_fused(bank, plans, PD_DP))
        err["decode_sum_fused"] = max(err["decode_sum_fused"],
                                      max_err(torch, got, want))
        c, loop = codecs.get_codec(codec), [None] * len(shapes)
        for r in range(PD_DP):
            pls = codecs.unfuse_payload(bank[r], structs)
            for i, shape in enumerate(shapes):
                m = collectives.unpack_grad_leaf(c, pls[i], shape)
                loop[i] = m if loop[i] is None else loop[i] + m
        max_err(torch, [a.reshape(l.shape) for a, l in zip(got, loop)], loop)
        log(f"# decode_sum_fused bit-exact vs plain and the unfused loop: "
            f"{label} ({bank.shape[1]} B a replica)")
        total = sum(p.n for p in plans)
        timed[label] = time_cases(torch, D, {"decode_sum_fused": (
            lambda: dp_reduce.decode_sum_fused(bank, plans, PD_DP),
            "decode_sum_kernel", None, PD_DP * bank.shape[1] + 4 * total,
            2 * PD_DP * total)})
        del bank
    gen = torch.Generator(device="cuda").manual_seed(13)
    hop32 = torch.randn(PD_HOP, generator=gen, device="cuda")
    hop = hop32.to(torch.bfloat16)
    # 4 rows fill no (8, n) wire tile: the q8 hop packs per tensor, as
    # the reference's does, and launches no quantize_wire
    assert tiling.wire_tiling(PD_HOP) is None
    for name, e in zip(("pack4_wire", "unpack4_wire"), check_q4(
            torch, D, pack4, hop32, *per_tensor_pair(pack4, hop32))):
        err[name] = e
    check_select(torch, D, topk, hop)
    log(f"# the q4 pair and the select bit-exact vs plain: {PD_HOP_LABEL}")
    timed[PD_HOP_LABEL] = time_select(torch, D, topk, [hop])
    timed[PD_HOP4_LABEL] = time_pack4(torch, D, pack4, hop32,
                                      per_tensor=True)
    for label, rows in timed.items():
        for name, row in rows.items():
            log(f"# {name} {label}: " + json.dumps(row))
    return err, timed


def tp_kernels(torch, D, quantize, pack4, topk, framing, codecs,
               collectives, tiling):
    """Phase 2 at the tensor axis' shapes (phase 10): at pipeline x TP's
    (8, 49,152) stage hop ``quantize_wire`` on the tiled q8 backward hop
    (bf16) and the q4 pair (f32, the codec's expanded pair); the q4 pair
    on the tensor wire's rows at tp 2 and at tp 4 / 3D, and the select on
    the latter; the framing pair on each of those payloads; the decode +
    sum at dp = 2 on one tensor coordinate's block of the DP x TP stack
    (q8, q4) and one (stage column, tensor coordinate) block of the 3D
    stack (q8).  Every one bit-exact against its plain version; then the
    tensor rows' q4 pair and select, and the DP x TP q8 decode, timed
    with their bounds.  Returns ({kernel: max error}, {label: {name:
    row}})."""
    from repro_torch.configs.registry import get
    from repro_torch.kernels import dp_reduce
    from repro_torch.models import transformer
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.transport.collectives import _column_struct
    err = dict.fromkeys(KERNELS, 0.0)
    gen = torch.Generator(device="cuda").manual_seed(17)
    hop32 = torch.randn(TP_HOP, generator=gen, device="cuda")
    hop = hop32.to(torch.bfloat16)
    row2 = torch.randn(TP_ROW2, generator=gen, device="cuda")
    row4 = torch.randn(TP_ROW4, generator=gen, device="cuda")
    block = tiling.wire_tiling(TP_HOP)
    assert block is not None          # 8 rows fill the q8 wire tile
    got, want = kernel_and_plain(
        torch, D, lambda: quantize.quantize_wire(hop, 8, block))
    err["quantize_wire"] = max_err(torch, got, want)
    for x in (hop32, row2, row4):
        for name, e in zip(("pack4_wire", "unpack4_wire"), check_q4(
                torch, D, pack4, x, *per_tensor_pair(pack4, x))):
            err[name] = max(err[name], e)
    check_select(torch, D, topk, row4)
    log(f"# quantize_wire bit-exact vs plain: {TP_HOP_LABEL} bf16 tile "
        f"{block}; the q4 pair at it (f32) and at {TP_ROW2_LABEL} and "
        f"{TP_ROW4_LABEL}, the select at the latter")
    for codec, x in (("q8", hop), ("q4", hop), ("q4", row2), ("q4", row4),
                     ("topk", row4)):
        parts = hop_payload_parts(torch, codecs, x, codec)
        sizes = [p.numel() for p in parts]
        got, want = kernel_and_plain(torch, D,
                                     lambda: framing.frame_parts(parts))
        err["frame_parts"] = max(err["frame_parts"],
                                 max_err(torch, [got], [torch.cat(parts)]))
        max_err(torch, [got], [want])
        segs, plain = kernel_and_plain(
            torch, D, lambda: framing.unframe_parts(want, sizes))
        err["unframe_parts"] = max(err["unframe_parts"],
                                   max_err(torch, segs, plain))
        max_err(torch, segs, [p.contiguous() for p in parts])
        log(f"# framing bit-exact vs plain: {codec} payload of "
            f"{tuple(x.shape)} {str(x.dtype)[6:]} {sizes}")
    params = transformer.init_params(
        torch.Generator(device="cuda").manual_seed(0), get("gpt2-small"))
    timed, dec = {}, {}
    for label, codec, stages in ((TP_BLK8, "q8", 1), (TP_BLK4, "q4", 1),
                                 (TP_BLK3D, "q8", 2)):
        like = (transformer.stack_layer_stages(params, stages)
                if stages > 1 else params["layers"])
        dims = tree_leaves(transformer.tp_param_dims(like))
        shapes = [lf.shape for lf in _column_struct(like, stages, 2, dims)]
        bank, plans, _, _ = dp_bank(torch, codecs, collectives, codec,
                                    shapes, 19, dp=2)
        got, want = kernel_and_plain(
            torch, D, lambda: dp_reduce.decode_sum_fused(bank, plans, 2))
        err["decode_sum_fused"] = max(err["decode_sum_fused"],
                                      max_err(torch, got, want))
        log(f"# decode_sum_fused bit-exact vs plain: {label} "
            f"({bank.shape[1]} B a replica)")
        if label == TP_BLK8:
            dec = (bank, plans)
        else:
            del bank
    del params
    bank, plans = dec
    total = sum(p.n for p in plans)
    timed[TP_BLK8] = time_cases(torch, D, {"decode_sum_fused": (
        lambda: dp_reduce.decode_sum_fused(bank, plans, 2),
        "decode_sum_kernel", None, 2 * bank.shape[1] + 4 * total,
        2 * 2 * total)})
    del bank, dec
    timed[TP_ROW2_LABEL] = time_pack4(torch, D, pack4, row2,
                                      per_tensor=True)
    timed[TP_ROW4_LABEL] = time_select(torch, D, topk, [row4])
    for label, rows in timed.items():
        for name, row in rows.items():
            log(f"# {name} {label}: " + json.dumps(row))
    return err, timed


def cs_kernels(torch, D, pack4, topk):
    """Phase 2 at phase 11's per-token cut shapes (a decode tick of 4
    slots, a 16-token prefill chunk, a 4 x 5-token verification span),
    one payload a row: the q4 pair on f32 with per-row statistics, the
    select on bf16 and f32 (k 77 a row), bit-exact against their plain
    versions; then the q4 pair (f32) and the select (bf16, as the TopK
    codec reads the cut) timed.  Returns ({kernel: max error}, {label:
    {name: row}})."""
    err = dict.fromkeys(KERNELS, 0.0)
    gen = torch.Generator(device="cuda").manual_seed(23)
    timed = {}
    for label, m in CS_SHAPES.items():
        x = torch.randn((m, D_MODEL), generator=gen, device="cuda")
        for name, e in zip(("pack4_wire", "unpack4_wire"), check_q4(
                torch, D, pack4, x, *pack4.minmax_scale(x))):
            err[name] = max(err[name], e)
        for dt in (torch.bfloat16, torch.float32):
            check_select(torch, D, topk, x.to(dt))
        log(f"# q4 pair and select bit-exact vs plain: {label}")
        timed[label] = time_pack4(torch, D, pack4, x)
        timed[label].update(time_select(torch, D, topk,
                                        [x.to(torch.bfloat16)]))
        for name, row in timed[label].items():
            log(f"# {name} {label}: " + json.dumps(row))
    return err, timed


# ---------------------------------------------------------------------------
# phase 3: serving
# ---------------------------------------------------------------------------

def serve(torch, np, D, build):
    from repro_torch.configs.registry import get
    from repro_torch.core.policy import POLICIES
    from repro_torch.models import transformer
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = get("gpt2-small")
    params = transformer.init_params(
        torch.Generator(device="cuda").manual_seed(0), cfg)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in PROMPT_LENS]

    def generate(name):
        eng = ServeEngine(params, cfg, POLICIES[name](), max_batch=BATCH,
                          max_seq=MAX_SEQ)
        out = eng.generate([Request(p, NEW_TOKENS) for p in prompts])
        toks = np.stack([r.out for r in out])
        assert toks.shape == (BATCH, NEW_TOKENS)
        assert ((toks >= 0) & (toks < cfg.vocab_size)).all()
        return toks

    tokens, moved = {}, {}
    build.reset_launches()                      # the main path starts here
    for name, kernels in POLICY_KERNELS.items():
        before = dict(build.LAUNCHES)
        tokens[name] = generate(name)
        moved[name] = {k: build.LAUNCHES.get(k, 0) - before.get(k, 0)
                       for k in KERNELS}
        for k in KERNELS:
            if (moved[name][k] > 0) != (k in kernels):
                raise AssertionError(f"policy {name}: {k} launched "
                                     f"{moved[name][k]} times")
        log(f"# served gpt2-small policy={name}: launches {moved[name]} "
            f"tokens[0][:8]={tokens[name][0, :8].tolist()}")
    torch.cuda.synchronize()
    launches = {k: build.LAUNCHES.get(k, 0) for k in KERNELS}  # read here
    per_token = {k: v / (BATCH * NEW_TOKENS) for k, v in launches.items()}
    log(f"# main-path launches {launches}; per token served under the "
        f"kernel's policy: {per_token}")

    D.KERNEL_BACKEND = "plain"
    try:
        for name in POLICY_KERNELS:
            plain = generate(name)
            if not np.array_equal(plain, tokens[name]):
                raise AssertionError(f"policy {name}: plain backend tokens "
                                     f"differ:\n{plain}\n{tokens[name]}")
    finally:
        D.KERNEL_BACKEND = "auto"
    log("# plain backend on the card gives identical tokens for every "
        "policy")
    check_against_cpu(torch, transformer, get)

    for name in POLICY_KERNELS:
        eng = ServeEngine(params, cfg, POLICIES[name](), max_batch=BATCH,
                          max_seq=MAX_SEQ)
        probe = eng.throughput_probe(BATCH, max(PROMPT_LENS), NEW_TOKENS)
        log("# throughput " + json.dumps({"policy": name, **probe}))
        profile_generate(torch, name, eng,
                         [Request(p, NEW_TOKENS) for p in prompts])
    return launches


def profile_generate(torch, name, eng, requests):
    """Where one served batch's time goes: wall time vs summed device time
    (the device's idle share) and the kernels taking the most device time,
    under torch.profiler (whose own cost inflates the wall time)."""
    from torch.profiler import ProfilerActivity, profile
    eng.generate(requests)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.generate(requests)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = sorted(device_records(prof), reverse=True)
    busy_ms = sum(ms for ms, _ in dev)
    log("# profile " + json.dumps({
        "policy": name, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1 - busy_ms / wall_ms,
        "top_device_ms": [[key[:60], ms] for ms, key in dev[:6]]}))


def check_against_cpu(torch, transformer, get):
    """The smoke model, same params and prompts, on the card and on the
    CPU: finite prefill logits within the bf16 tolerance."""
    import dataclasses
    from repro_torch.core.policy import POLICIES
    cfg = dataclasses.replace(get("gpt2-small", smoke=True), num_layers=4)
    params = transformer.init_params(torch.Generator().manual_seed(1), cfg)
    on_card = _tree_to(params, "cuda")
    gen = torch.Generator().manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (BATCH, 16), generator=gen)
    pad = torch.tensor([0, 3, 7, 11])
    cpu, _ = transformer.prefill(params, {"tokens": toks}, cfg,
                                 POLICIES["none"](), cache_len=32,
                                 pad_len=pad, wire=True)
    card, _ = transformer.prefill(on_card, {"tokens": toks.cuda()}, cfg,
                                  POLICIES["none"](), cache_len=32,
                                  pad_len=pad.cuda(), wire=True)
    card = card.float().cpu()
    assert bool(torch.isfinite(card).all()), "non-finite logits on the card"
    gap = (card - cpu.float()).abs().max().item()
    if gap > LOGIT_ATOL:
        raise AssertionError(f"card vs CPU prefill logits differ by {gap}")
    log(f"# smoke prefill logits, card vs CPU: max gap {gap} "
        f"(<= {LOGIT_ATOL})")


# ---------------------------------------------------------------------------
# phase 4: training
# ---------------------------------------------------------------------------

def grad_accum_of(name):
    """The gradient-accumulation pieces of a phase 4 or 6 run."""
    return 2 if name.endswith("/accum2") else 1


def train_run(torch, cfg, params, name, build, steps=TRAIN_STEPS,
              profile_step=None):
    """``steps`` train steps of ``name`` from ``params``, built as
    ``launch/train`` builds its run.  Returns the losses, each step's
    launches, each step's wall seconds and the profile of step
    ``profile_step`` (1-based) if asked."""
    from repro_torch.core.boundary import init_boundary_state
    from repro_torch.launch.train import build_policy, synthetic_stream
    from repro_torch.models.transformer import segment_bounds
    from repro_torch.optim.optimizers import OptimizerConfig, init_opt_state
    from repro_torch.train.steps import make_lm_train_step

    policy = build_policy(*TRAIN_POLICIES[name][0])
    opt = OptimizerConfig(kind="adamw", lr=1e-3, weight_decay=0.01,
                          schedule="cosine", t_max=steps, grad_clip=1.0)
    cuts = len(segment_bounds(cfg.num_groups, policy.num_stages)) - 1
    bstates = [init_boundary_state(policy.at(i), (TRAIN_SEQ, cfg.d_model),
                                   batch=TRAIN_BATCH,
                                   num_samples=AQSGD_SAMPLES,
                                   dtype=torch.bfloat16, device="cuda")
               for i in range(cuts)]
    step = make_lm_train_step(cfg, policy, opt,
                              grad_accum=grad_accum_of(name))
    stream = synthetic_stream(cfg, TRAIN_BATCH, TRAIN_SEQ, 0,
                              num_samples=AQSGD_SAMPLES)
    opt_state = init_opt_state(opt, params)
    losses, launches, seconds, prof = [], [], [], None
    for i in range(1, steps + 1):
        toks, ids = next(stream)
        batch = {"tokens": torch.from_numpy(toks).to("cuda", torch.int64)}
        ids = torch.from_numpy(ids).to("cuda")
        before = dict(build.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == profile_step:
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                params, opt_state, bstates, m = step(params, opt_state,
                                                     bstates, batch, ids)
                torch.cuda.synchronize()
        else:
            params, opt_state, bstates, m = step(params, opt_state, bstates,
                                                 batch, ids)
            torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        launches.append({k: build.LAUNCHES.get(k, 0) - before.get(k, 0)
                         for k in KERNELS})
    return {"losses": losses, "launches": launches, "seconds": seconds,
            "params": params, "profile": prof}


def train(torch, D, build):
    from repro_torch.configs.registry import get
    from repro_torch.core.policy import POLICIES
    from repro_torch.launch.train import synthetic_stream
    from repro_torch.models import transformer
    from repro_torch.train.steps import make_lm_eval_step

    cfg = get("gpt2-small")
    params = transformer.init_params(
        torch.Generator(device="cuda").manual_seed(0), cfg)
    build.reset_launches()                  # the training path starts here
    runs = {name: train_run(torch, cfg, params, name, build)
            for name in TRAIN_POLICIES}
    torch.cuda.synchronize()
    launches = {k: build.LAUNCHES.get(k, 0) for k in KERNELS}  # read here
    log(f"# training-path launches {launches}")
    for name, (_, kernel, per_step) in TRAIN_POLICIES.items():
        run = runs[name]
        want = {k: per_step if k == kernel else 0 for k in KERNELS}
        for i, got in enumerate(run["launches"]):
            if got != want:
                raise AssertionError(f"train {name} step {i + 1}: launches "
                                     f"{got}, expected {want}")
        losses = run["losses"]
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"train {name}: non-finite loss {losses}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"train {name}: loss did not fall {losses}")
        tok_s = (TRAIN_BATCH * TRAIN_SEQ * (TRAIN_STEPS - 1)
                 / sum(run["seconds"][1:]))
        log("# train " + json.dumps({
            "policy": name, "losses": losses,
            "launches_per_step": run["launches"][0],
            "step_s": run["seconds"], "tokens_per_s_steps_2_to_4": tok_s}))
    one, two = (runs[n]["launches"][0]["quant_dequant"]
                for n in ("q4q8", "q4q8/accum2"))
    if two != 2 * one:
        raise AssertionError(f"q4q8 with grad_accum=2 launched {two} cut "
                             f"kernels a step, not twice {one}")
    log(f"# q4q8 with grad_accum=2: {two} cut launches a step, twice the "
        f"un-accumulated run's {one}")

    D.KERNEL_BACKEND = "plain"
    try:
        for name in TRAIN_POLICIES:
            plain = train_run(torch, cfg, params, name, build)["losses"]
            if plain != runs[name]["losses"]:
                raise AssertionError(f"train {name}: plain backend losses "
                                     f"{plain} != {runs[name]['losses']}")
    finally:
        D.KERNEL_BACKEND = "auto"
    log("# plain backend on the card gives identical losses for every "
        "policy")

    # finding F3: the q4q8-trained model evaluated with and without it
    policy = POLICIES["q4q8"]()
    toks = next(synthetic_stream(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=7))[0]
    batch = {"tokens": torch.from_numpy(toks).to("cuda", torch.int64)}
    evals = {}
    for compress, want in ((True, 3), (False, 0)):
        before = build.LAUNCHES.get("quant_dequant", 0)
        evals[compress] = float(make_lm_eval_step(cfg, policy, compress)(
            runs["q4q8"]["params"], batch))
        got = build.LAUNCHES.get("quant_dequant", 0) - before
        if got != want or not math.isfinite(evals[compress]):
            raise AssertionError(f"eval compress={compress}: {got} "
                                 f"launches, loss {evals[compress]}")
    log("# eval of the q4q8 model " + json.dumps(
        {"loss_on": evals[True], "loss_off": evals[False],
         "launches_on": 3, "launches_off": 0}))

    check_train_against_cpu(torch, transformer, get)
    for name in TRAIN_POLICIES:
        prof = train_run(torch, cfg, params, name, build, steps=3,
                         profile_step=3)
        dev = sorted(device_records(prof["profile"]), reverse=True)
        busy_ms = sum(ms for ms, _ in dev)
        wall_ms = prof["seconds"][2] * 1e3
        # the profiler inflates the wall time; the unprofiled steps 2-4 of
        # the run above give the idle share without its cost
        step_ms = 1e3 * sorted(runs[name]["seconds"][1:])[1]
        log("# train profile " + json.dumps({
            "policy": name, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / wall_ms,
            "unprofiled_step_ms": step_ms,
            "device_idle_share_unprofiled": 1 - busy_ms / step_ms,
            "top_device_ms": [[key[:60], ms] for ms, key in dev[:6]]}))
    return launches


def check_train_against_cpu(torch, transformer, get):
    """Two steps of the smoke model without compression on the card and
    on the CPU (which the CPU tests hold to the JAX package): losses
    within the CPU tests' tolerance."""
    import dataclasses
    import numpy as np
    from repro_torch.core.policy import NO_POLICY
    from repro_torch.optim.optimizers import OptimizerConfig, init_opt_state
    from repro_torch.train.steps import make_lm_train_step
    cfg = dataclasses.replace(get("gpt2-small", smoke=True), num_layers=4)
    params = transformer.init_params(torch.Generator().manual_seed(1), cfg)
    opt = OptimizerConfig(kind="adamw", lr=1e-3, weight_decay=0.01,
                          schedule="cosine", t_max=2, grad_clip=1.0)
    rng = np.random.RandomState(2)
    toks = [torch.from_numpy(rng.randint(0, cfg.vocab_size, (4, 32)))
            for _ in range(2)]
    losses = {}
    for dev in ("cpu", "cuda"):
        p = _tree_to(params, dev)
        o = init_opt_state(opt, p)
        step = make_lm_train_step(cfg, NO_POLICY, opt)
        losses[dev] = []
        for t in toks:
            p, o, _, m = step(p, o, [], {"tokens": t.to(dev)},
                              torch.arange(4, device=dev))
            losses[dev].append(float(m["loss"]))
    gap = max(abs(a - b) for a, b in zip(losses["cpu"], losses["cuda"]))
    if not gap <= LOSS_ATOL:
        raise AssertionError(f"smoke train losses, card {losses['cuda']} "
                             f"vs CPU {losses['cpu']}")
    log(f"# smoke train step losses, card vs CPU: {losses['cuda']} vs "
        f"{losses['cpu']}, max gap {gap} (<= {LOSS_ATOL})")


# ---------------------------------------------------------------------------
# phase 5: the real pipeline
# ---------------------------------------------------------------------------

def pipe_policy(name, stages):
    import dataclasses
    from repro_torch.launch.train import build_policy
    pname, feedback = PIPE_RUNS[name][:2]
    return dataclasses.replace(build_policy(pname, feedback, 0.1),
                               num_stages=stages)


def pipe_run(torch, cfg, params, name, build, steps=PIPE_STEPS,
             profile_step=None):
    """``steps`` pipeline train steps of run ``name`` from ``params``,
    built as ``launch/train --transport pipeline`` builds its run.
    Returns the losses, each step's launches, wire counters and wall
    seconds, the final params and the profile of ``profile_step``."""
    from repro_torch.launch.train import synthetic_stream
    from repro_torch.optim.optimizers import OptimizerConfig, init_opt_state
    from repro_torch.train.loop import _pipeline_bstates
    from repro_torch.train.steps import make_lm_train_step

    _, _, sched, v = PIPE_RUNS[name][:4]
    stages = PIPE_STAGES // v
    policy = pipe_policy(name, stages)
    opt = OptimizerConfig(kind="adamw", lr=1e-3, weight_decay=0.01,
                          schedule="cosine", t_max=steps, grad_clip=1.0)
    bstates = _pipeline_bstates(policy, (PIPE_SEQ, cfg.d_model),
                                batch=PIPE_BATCH, microbatches=PIPE_MB,
                                num_samples=PIPE_SAMPLES,
                                dtype=torch.bfloat16, virtual_stages=v,
                                device="cuda")
    step = make_lm_train_step(cfg, policy, opt, transport="pipeline",
                              pipeline_microbatches=PIPE_MB, schedule=sched,
                              virtual_stages=v)
    stream = synthetic_stream(cfg, PIPE_BATCH, PIPE_SEQ, 0,
                              num_samples=PIPE_SAMPLES)
    opt_state = init_opt_state(opt, params)
    out = {"losses": [], "launches": [], "wire": [], "seconds": [],
           "profile": None}
    for i in range(1, steps + 1):
        toks, ids = next(stream)
        batch = {"tokens": torch.from_numpy(toks).to("cuda", torch.int64)}
        ids = torch.from_numpy(ids).to("cuda")
        before = dict(build.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == profile_step:
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                params, opt_state, bstates, m = step(params, opt_state,
                                                     bstates, batch, ids)
                torch.cuda.synchronize()
            out["profile"] = prof
        else:
            params, opt_state, bstates, m = step(params, opt_state, bstates,
                                                 batch, ids)
            torch.cuda.synchronize()
        out["seconds"].append(time.perf_counter() - t0)
        out["losses"].append(float(m["loss"]))
        out["wire"].append(m["wire"])
        out["launches"].append({k: build.LAUNCHES.get(k, 0) - before.get(k, 0)
                                for k in KERNELS})
    out["params"] = params
    return out


def pipe_expected_wire(name):
    """Bytes and hops per step of run ``name`` from ``wire_telemetry``,
    checked against the payload sizes of one full-width microbatch."""
    from repro_torch.transport.pipeline import (PipelineTransport,
                                                wire_telemetry)
    from repro_torch.transport.schedules import get_schedule
    from repro_torch.train.steps import _uniform_boundary
    _, _, sched, v, _, (fw, bw) = PIPE_RUNS[name]
    schedule = get_schedule(sched, v)
    stages = PIPE_STAGES // v
    tel = wire_telemetry(
        PipelineTransport(_uniform_boundary(pipe_policy(name, stages)),
                          stages, virtual_stages=v,
                          fused=schedule.fused_wire),
        schedule, MB_SHAPE, microbatches=PIPE_MB)
    hops = PIPE_MB * tel["wire_cuts"]
    assert hops == PIPE_HOPS, (name, hops)
    assert tel["fw_payload_bytes_per_hop"] == PAYLOAD_BYTES[fw], (name, tel)
    assert tel["bw_payload_bytes_per_hop"] == PAYLOAD_BYTES[bw], (name, tel)
    return {"fw_hops": hops, "bw_hops": hops,
            "fw_bytes": hops * tel["fw_payload_bytes_per_hop"],
            "bw_bytes": hops * tel["bw_payload_bytes_per_hop"]}


def pipeline(torch, D, build, held=None):
    from repro_torch.configs.registry import get
    from repro_torch.models import transformer

    cfg = get("gpt2-small")
    params = transformer.init_params(
        torch.Generator(device="cuda").manual_seed(0), cfg)
    build.reset_launches()                  # the pipeline path starts here
    runs = {name: pipe_run(torch, cfg, params, name, build)
            for name in PIPE_RUNS}
    torch.cuda.synchronize()
    launches = {k: build.LAUNCHES.get(k, 0) for k in KERNELS}  # read here
    log(f"# pipeline-path launches {launches}")
    if held is not None:                    # phase 18 is held to these
        held.update({n: {k: runs[n][k] for k in ("losses", "launches",
                                                  "wire", "seconds")}
                     for n in RANK_RUNS})
    for name, spec in PIPE_RUNS.items():
        run, want = runs[name], spec[4]
        for i, got in enumerate(run["launches"]):
            if got != want:
                raise AssertionError(f"pipeline {name} step {i + 1}: "
                                     f"launches {got}, expected {want}")
        wire = pipe_expected_wire(name)
        for i, got in enumerate(run["wire"]):
            if got != wire:
                raise AssertionError(f"pipeline {name} step {i + 1}: wire "
                                     f"{got}, expected {wire}")
        losses = run["losses"]
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"pipeline {name}: non-finite loss {losses}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"pipeline {name}: loss did not fall "
                                 f"{losses}")
        tok_s = (PIPE_BATCH * PIPE_SEQ * (PIPE_STEPS - 1)
                 / sum(run["seconds"][1:]))
        log("# pipeline " + json.dumps({
            "run": name, "losses": losses,
            "launches_per_step": {k: v for k, v in run["launches"][0].items()
                                  if v},
            "wire_per_step": run["wire"][0], "step_s": run["seconds"],
            "tokens_per_s_steps_2_to_3": tok_s}))
    for pol in ("q4q8", "aqsgd"):
        a, b = runs[f"gpipe/{pol}"], runs[f"1f1b/{pol}"]
        if a["losses"] != b["losses"]:
            raise AssertionError(f"1f1b != gpipe under {pol}: "
                                 f"{b['losses']} vs {a['losses']}")
        for (n, x), (_, y) in zip(_leaves(a["params"]), _leaves(b["params"])):
            if not torch.equal(x, y):
                raise AssertionError(f"1f1b != gpipe under {pol}: param {n}")
    log("# 1f1b equals gpipe bitwise (losses and params after 3 steps) "
        "under q4q8 and aqsgd")

    D.KERNEL_BACKEND = "plain"
    try:
        for name in PIPE_RUNS:
            plain = pipe_run(torch, cfg, params, name, build)["losses"]
            if plain != runs[name]["losses"]:
                raise AssertionError(f"pipeline {name}: plain backend "
                                     f"losses {plain} != "
                                     f"{runs[name]['losses']}")
    finally:
        D.KERNEL_BACKEND = "auto"
    log("# plain backend on the card gives identical pipeline losses for "
        "every run")

    check_pipeline_against_cpu(torch, transformer, get)
    for name in ("gpipe/q4q8", "1f1b/q4q8", "interleaved/q4q8"):
        prof = pipe_run(torch, cfg, params, name, build, steps=2,
                        profile_step=2)
        dev = sorted(device_records(prof["profile"]), reverse=True)
        busy_ms = sum(ms for ms, _ in dev)
        wall_ms = prof["seconds"][1] * 1e3
        step_ms = 1e3 * min(runs[name]["seconds"][1:])
        log("# pipeline profile " + json.dumps({
            "run": name, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / wall_ms,
            "unprofiled_step_ms": step_ms,
            "device_idle_share_unprofiled": 1 - busy_ms / step_ms,
            "top_device_ms": [[key[:60], ms] for ms, key in dev[:6]]}))
    return launches


def check_pipeline_against_cpu(torch, transformer, get):
    """One pipeline step of the smoke model (4 layer groups, 2 stages, 2
    microbatches) on the card and on the CPU, which the CPU tests hold to
    the JAX package: without compression within the train tolerance,
    under q4q8 / 1f1b within the compressed one."""
    import dataclasses
    import numpy as np
    from repro_torch.core.policy import POLICIES
    from repro_torch.optim.optimizers import OptimizerConfig, init_opt_state
    from repro_torch.train.steps import make_lm_train_step
    cfg = dataclasses.replace(get("gpt2-small", smoke=True), num_layers=4)
    params = transformer.init_params(torch.Generator().manual_seed(1), cfg)
    opt = OptimizerConfig(kind="adamw", lr=1e-3, weight_decay=0.01,
                          schedule="cosine", t_max=1, grad_clip=1.0)
    toks = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.vocab_size, (16, 32)))
    for pname, sched, tol in (("none", "gpipe", LOSS_ATOL),
                              ("q4q8", "1f1b", LM_LOSS_ATOL)):
        policy = dataclasses.replace(POLICIES[pname](), num_stages=2)
        losses = {}
        for dev in ("cpu", "cuda"):
            p = _tree_to(params, dev)
            step = make_lm_train_step(cfg, policy, opt, transport="pipeline",
                                      pipeline_microbatches=2,
                                      schedule=sched)
            _, _, _, m = step(p, init_opt_state(opt, p), [],
                              {"tokens": toks.to(dev)},
                              torch.arange(16, device=dev))
            losses[dev] = float(m["loss"])
        gap = abs(losses["cpu"] - losses["cuda"])
        if not (math.isfinite(losses["cuda"]) and gap <= tol):
            raise AssertionError(f"smoke pipeline {pname}/{sched}: card "
                                 f"{losses['cuda']} vs CPU {losses['cpu']}")
        log(f"# smoke pipeline step {pname}/{sched}, card vs CPU: "
            f"{losses['cuda']} vs {losses['cpu']}, gap {gap} (<= {tol})")


# ---------------------------------------------------------------------------
# phase 6: data-parallel training with the compressed gradient all-reduce
# ---------------------------------------------------------------------------

def dp_spec(name):
    from repro_torch.core.parallel import AxisSpec, ParallelSpec
    codec, fb, k_frac = DP_RUNS[name][:3]
    return ParallelSpec({"data": AxisSpec(size=DP, codec=codec, feedback=fb,
                                          k_frac=k_frac)})


def make_timed_dp_step(torch, cfg, policy, opt, spec, reduce_events,
                       grad_accum=1):
    """``make_lm_train_step(parallel=spec, grad_accum=...)`` whose reduce
    records a pair of CUDA events around each call into
    ``reduce_events``."""
    import repro_torch.train.steps as TS
    real = TS.make_grad_all_reduce

    def timed(*a, **kw):
        red = real(*a, **kw)

        def reduce(grads, state):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = red(grads, state)
            ev[1].record()
            reduce_events.append(ev)
            return out
        return reduce

    TS.make_grad_all_reduce = timed
    try:
        return TS.make_lm_train_step(cfg, policy, opt, parallel=spec,
                                     grad_accum=grad_accum)
    finally:
        TS.make_grad_all_reduce = real


def dp_run(torch, cfg, params, name, build, steps=DP_STEPS,
           profile_step=None):
    """``steps`` data-parallel train steps of run ``name`` from ``params``,
    built as ``launch/train --mesh data=4 --wire data=...`` builds its
    run (the cosine over ``DP_STEPS``).  Returns the losses, each step's
    launches, ring bytes, wall seconds, CUDA-event step and reduce ms,
    and the profile of ``profile_step``."""
    from repro_torch.core.boundary import init_boundary_state
    from repro_torch.launch.train import build_policy, synthetic_stream
    from repro_torch.models.transformer import segment_bounds
    from repro_torch.optim.optimizers import OptimizerConfig, init_opt_state
    from repro_torch.train.loop import init_lm_dp_state

    _, dfb, _, pname, fb, _ = DP_RUNS[name]
    policy = build_policy(pname, fb, 0.1)
    opt = OptimizerConfig(kind="adamw", lr=1e-3, weight_decay=0.01,
                          schedule="cosine", t_max=DP_STEPS, grad_clip=1.0)
    cuts = len(segment_bounds(cfg.num_groups, policy.num_stages)) - 1
    bstates = [init_boundary_state(policy.at(i), (DP_SEQ, cfg.d_model),
                                   batch=DP_BATCH, num_samples=DP_SAMPLES,
                                   dtype=torch.bfloat16, device="cuda")
               for i in range(cuts)]
    reduce_events = []
    step = make_timed_dp_step(torch, cfg, policy, opt, dp_spec(name),
                              reduce_events, grad_accum_of(name))
    dp_state = init_lm_dp_state(cfg, params, policy, DP, dfb)
    stream = synthetic_stream(cfg, DP_BATCH, DP_SEQ, 0,
                              num_samples=DP_SAMPLES, dp=DP)
    opt_state = init_opt_state(opt, params)
    out = {"losses": [], "launches": [], "dp_bytes": [], "seconds": [],
           "step_ms": [], "reduce_ms": [], "profile": None}
    for i in range(1, steps + 1):
        toks, ids = next(stream)
        batch = {"tokens": torch.from_numpy(toks).to("cuda", torch.int64)}
        ids = torch.from_numpy(ids).to("cuda")
        before = dict(build.LAUNCHES)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        if i == profile_step:
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                params, opt_state, bstates, dp_state, m = step(
                    params, opt_state, bstates, batch, ids, dp_state)
                torch.cuda.synchronize()
            out["profile"] = prof
        else:
            params, opt_state, bstates, dp_state, m = step(
                params, opt_state, bstates, batch, ids, dp_state)
        ev[1].record()
        torch.cuda.synchronize()
        out["seconds"].append(time.perf_counter() - t0)
        out["step_ms"].append(ev[0].elapsed_time(ev[1]))
        r0, r1 = reduce_events[-1]
        out["reduce_ms"].append(r0.elapsed_time(r1))
        out["losses"].append(float(m["loss"]))
        out["dp_bytes"].append(m["wire"]["dp_bytes"])
        out["launches"].append({k: build.LAUNCHES.get(k, 0) - before.get(k, 0)
                                for k in KERNELS})
    return out


def dp_expected_bytes(name, params):
    """Ring bytes per step: dp (dp - 1) hops of ``dp_wire_report``'s
    buffer, checked against the q8 / q4 payload sizes."""
    from repro_torch.transport.collectives import dp_wire_report
    codec, _, k_frac = DP_RUNS[name][:3]
    rep = dp_wire_report(params, codec, k_frac=k_frac, dp=DP)
    if codec in DP_PAYLOAD:
        assert rep["payload_bytes_per_hop"] == DP_PAYLOAD[codec], rep
    assert rep["n_param_leaves"] == LEAVES, rep
    return DP * rep["wire_bytes_per_reduce"]


def data_parallel(torch, D, build):
    from repro_torch.configs.registry import get
    from repro_torch.models import transformer

    cfg = get("gpt2-small")
    params = transformer.init_params(
        torch.Generator(device="cuda").manual_seed(0), cfg)
    build.reset_launches()                  # the DP path starts here
    runs = {name: dp_run(torch, cfg, params, name, build)
            for name in DP_RUNS}
    torch.cuda.synchronize()
    launches = {k: build.LAUNCHES.get(k, 0) for k in KERNELS}  # read here
    log(f"# dp-path launches {launches}")
    for name, spec in DP_RUNS.items():
        run, want = runs[name], spec[5]
        for i, got in enumerate(run["launches"]):
            if got != want:
                raise AssertionError(f"dp {name} step {i + 1}: launches "
                                     f"{got}, expected {want}")
        nbytes = dp_expected_bytes(name, params)
        if run["dp_bytes"] != [nbytes] * DP_STEPS:
            raise AssertionError(f"dp {name}: ring bytes {run['dp_bytes']}, "
                                 f"expected {nbytes} a step")
        losses = run["losses"]
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"dp {name}: non-finite loss {losses}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"dp {name}: loss did not fall {losses}")
        tok_s = (DP_BATCH * DP_SEQ * (DP_STEPS - 1)
                 / sum(run["seconds"][1:]))
        log("# dp " + json.dumps({
            "run": name, "losses": losses,
            "launches_per_step": {k: v for k, v in run["launches"][0].items()
                                  if v},
            "dp_bytes_per_step": run["dp_bytes"][0], "step_s": run["seconds"],
            "step_ms_cuda_events": run["step_ms"],
            "reduce_ms_cuda_events": run["reduce_ms"],
            "reduce_share": [r / t for r, t in zip(run["reduce_ms"],
                                                   run["step_ms"])],
            "tokens_per_s_steps_2_to_3": tok_s}))

    D.KERNEL_BACKEND = "plain"
    try:
        for name in DP_RUNS:
            plain = dp_run(torch, cfg, params, name, build)["losses"]
            if plain != runs[name]["losses"]:
                raise AssertionError(f"dp {name}: plain backend losses "
                                     f"{plain} != {runs[name]['losses']}")
    finally:
        D.KERNEL_BACKEND = "auto"
    log("# plain backend on the card gives identical DP losses for every "
        "run")

    check_dp_against_cpu(torch, transformer, get)
    name = "q8/q4q8"
    prof = dp_run(torch, cfg, params, name, build, steps=2, profile_step=2)
    dev = sorted(device_records(prof["profile"]), reverse=True)
    busy_ms = sum(ms for ms, _ in dev)
    wall_ms = prof["seconds"][1] * 1e3
    step_ms = 1e3 * min(runs[name]["seconds"][1:])
    log("# dp profile " + json.dumps({
        "run": name, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1 - busy_ms / wall_ms,
        "unprofiled_step_ms": step_ms,
        "device_idle_share_unprofiled": 1 - busy_ms / step_ms,
        "top_device_ms": [[key[:60], ms] for ms, key in dev[:8]]}))
    return launches


def check_dp_against_cpu(torch, transformer, get):
    """Two DP steps (dp 2, batch 4, seq 32) of the smoke model on the card
    and on the CPU (which the CPU tests hold to the JAX package): the DP
    codec none within the train tolerance, q8 within the compressed one;
    step 2's loss reads step 1's reduced update."""
    import dataclasses
    import numpy as np
    from repro_torch.core.parallel import AxisSpec, ParallelSpec
    from repro_torch.core.policy import NO_POLICY
    from repro_torch.optim.optimizers import OptimizerConfig, init_opt_state
    from repro_torch.train.loop import init_lm_dp_state
    from repro_torch.train.steps import make_lm_train_step
    cfg = dataclasses.replace(get("gpt2-small", smoke=True), num_layers=4)
    params = transformer.init_params(torch.Generator().manual_seed(1), cfg)
    opt = OptimizerConfig(kind="adamw", lr=1e-3, weight_decay=0.01,
                          schedule="cosine", t_max=2, grad_clip=1.0)
    rng = np.random.RandomState(2)
    toks = [torch.from_numpy(rng.randint(0, cfg.vocab_size, (4, 32)))
            for _ in range(2)]
    for codec, tol in (("none", LOSS_ATOL), ("q8", LM_LOSS_ATOL)):
        spec = ParallelSpec({"data": AxisSpec(size=2, codec=codec)})
        losses = {}
        for dev in ("cpu", "cuda"):
            p = _tree_to(params, dev)
            o = init_opt_state(opt, p)
            st = init_lm_dp_state(cfg, p, NO_POLICY, 2)
            step = make_lm_train_step(cfg, NO_POLICY, opt, parallel=spec)
            losses[dev] = []
            for t in toks:
                p, o, _, st, m = step(p, o, [], {"tokens": t.to(dev)},
                                      torch.arange(4, device=dev), st)
                losses[dev].append(float(m["loss"]))
        gap = max(abs(a - b) for a, b in zip(losses["cpu"], losses["cuda"]))
        if not (all(math.isfinite(v) for v in losses["cuda"])
                and gap <= tol):
            raise AssertionError(f"smoke DP step {codec}: card "
                                 f"{losses['cuda']} vs CPU {losses['cpu']}")
        log(f"# smoke DP step dp=2 {codec}, card vs CPU: {losses['cuda']} "
            f"vs {losses['cpu']}, max gap {gap} (<= {tol})")


# ---------------------------------------------------------------------------
# phase 7: the paper's CNN experiment (ResNet18 through compressed cuts)
# ---------------------------------------------------------------------------

def cnn_policy(name, stages=4):
    from repro_torch.core import policy as P
    bp = {"none": P.NO_COMPRESSION, "q4q8": P.quant_policy(4, 8),
          "top10": P.topk_policy(0.1), "ef21": P.ef_policy(0.1, "ef21"),
          "aqsgd": P.aqsgd_policy(0.1)}[name]
    return P.CompressionPolicy(num_stages=stages, boundary=bp)


def cnn_opt(batch):
    """``run_cnn_experiment``'s default SGD over its default 8 epochs."""
    from repro_torch.train.loop import cnn_sgd
    return cnn_sgd(8, CNN_TRAIN, batch)


def cnn_kernels(torch, D, ops, quantize, pack4, topk, framing, codecs,
                tiling):
    """Phase 2 at the CNN's shapes: the cut kernels (bits 2/4/8, k
    10%/5%) at the three ResNet18 cuts, batch 100, f32 (tile (4, 2048)),
    the quantizer (bits 4/8) at the pipeline CNN's eval cut (128, 65,536)
    f32 (tile (128, 2048)), and the hop kernels (the q8 wire quantizer,
    the q4 pair with the codec's expanded pair, the TopK select, framing
    of the q8-tiled backward and the q4 forward payload) at the pipeline
    hop (32, 65,536) f32 (wire tile (32, 2048)), bit-exact against their
    plain versions, then timed.  Returns (err, {label: {name: row}})."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    err = dict.fromkeys(KERNELS, 0.0)
    timed = {}
    for shape, label in CNN_CUT_LABELS.items():
        x = torch.randn(shape, generator=gen, device="cuda")
        assert ops._tile(x) == (4, 2048), ops._tile(x)
        for bits in (2, 4, 8):
            got, want = kernel_and_plain(
                torch, D, lambda: ops.quant_dequant_op(x, bits))
            err["quant_dequant"] = max(err["quant_dequant"],
                                       max_err(torch, [got], [want]))
        for k_frac in (0.1, 0.05):
            got, want = kernel_and_plain(
                torch, D, lambda: ops.topk_block_op(x, k_frac))
            err["topk_block"] = max(err["topk_block"],
                                    max_err(torch, [got], [want]))
        log(f"# cut kernels bit-exact vs plain: {label}")
        timed[label] = time_cut_kernels(torch, D, ops, x)
    x = torch.randn(CNN_EVAL_CUT, generator=gen, device="cuda")
    assert ops._tile(x) == (128, 2048), ops._tile(x)
    for bits in (4, 8):
        got, want = kernel_and_plain(
            torch, D, lambda: ops.quant_dequant_op(x, bits))
        err["quant_dequant"] = max(err["quant_dequant"],
                                   max_err(torch, [got], [want]))
    log(f"# quant_dequant bit-exact vs plain: {CNN_EVAL_LABEL} (bits 4, 8)")
    timed[CNN_EVAL_LABEL] = time_cut_kernels(torch, D, ops, x,
                                             ("quant_dequant",))
    hop = torch.randn(CNN_HOP, generator=gen, device="cuda")
    block = tiling.wire_tiling(CNN_HOP)
    assert block == (32, 2048), block
    got, want = kernel_and_plain(
        torch, D, lambda: quantize.quantize_wire(hop, 8, block))
    err["quantize_wire"] = max_err(torch, got, want)
    for name, e in zip(("pack4_wire", "unpack4_wire"),
                       check_q4(torch, D, pack4, hop,
                                *per_tensor_pair(pack4, hop))):
        err[name] = e
    check_select(torch, D, topk, hop)
    framed_sizes = []
    for codec in ("q8", "q4"):
        parts = hop_payload_parts(torch, codecs, hop, codec)
        sizes = [p.numel() for p in parts]
        framed, plain = kernel_and_plain(torch, D,
                                         lambda: framing.frame_parts(parts))
        if not torch.equal(framed, torch.cat(parts)):
            raise AssertionError(f"frame_parts {codec} hop != torch.cat")
        err["frame_parts"] = max(err["frame_parts"],
                                 max_err(torch, [framed], [plain]))
        segs, plain = kernel_and_plain(
            torch, D, lambda: framing.unframe_parts(framed, sizes))
        err["unframe_parts"] = max(err["unframe_parts"],
                                   max_err(torch, segs, plain))
        framed_sizes.append(sizes)
    log(f"# hop kernels bit-exact vs plain: {CNN_HOP_LABEL} (quantize_wire "
        f"tile {block}, the q4 pair, the TopK select, framing "
        f"{framed_sizes[0]} (q8) and {framed_sizes[1]} (q4))")
    timed[CNN_HOP_LABEL] = {
        **time_quantize_wire(torch, D, quantize, tiling, hop),
        **time_pack4(torch, D, pack4, hop, per_tensor=True),
        **time_select(torch, D, topk, [hop])}
    timed[CNN_FRAMED] = time_hop_framing(torch, D, framing, codecs, hop)
    timed[CNN_FRAMED4] = time_hop_framing(torch, D, framing, codecs, hop,
                                          "q4")
    for label, rows in timed.items():
        for name, row in rows.items():
            log(f"# {name} {label}: " + json.dumps(row))
    return err, timed


def cnn_steps(torch, build, step, state, batches, profile_step=None):
    """Runs ``step(params, opt_state, bstates, images, labels, ids)`` over
    ``batches`` from ``state``; returns the losses, each step's launches,
    wire counters (pipeline) and wall seconds, the final params and the
    profile of step ``profile_step`` (1-based)."""
    params, opt_state, bstates = state
    out = {"losses": [], "launches": [], "wire": [], "seconds": [],
           "profile": None}
    for i, (x, y, ids) in enumerate(batches, 1):
        x, y, ids = (torch.from_numpy(a).to("cuda") for a in (x, y, ids))
        before = dict(build.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == profile_step:
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                params, opt_state, bstates, m = step(params, opt_state,
                                                     bstates, x, y, ids)
                torch.cuda.synchronize()
            out["profile"] = prof
        else:
            params, opt_state, bstates, m = step(params, opt_state, bstates,
                                                 x, y, ids)
            torch.cuda.synchronize()
        out["seconds"].append(time.perf_counter() - t0)
        out["losses"].append(float(m["loss"]))
        out["wire"].append(m.get("wire"))
        out["launches"].append({k: build.LAUNCHES.get(k, 0) - before.get(k, 0)
                                for k in KERNELS})
    out["params"] = params
    return out


def cnn_run(torch, data, params, name, build, steps=CNN_STEPS,
            profile_step=None):
    """``steps`` simulated-cut steps of ResNet18 under ``name``."""
    from repro_torch.optim.optimizers import init_opt_state
    from repro_torch.train.loop import _cnn_bstates
    from repro_torch.train.steps import make_cnn_train_step
    policy = cnn_policy(name)
    opt = cnn_opt(CNN_BATCH)
    step = make_cnn_train_step(policy, opt)
    state = (params, init_opt_state(opt, params),
             _cnn_bstates(policy, data, CNN_BATCH, CNN_WIDTH, "cuda"))
    batches = [b for _, b in zip(range(steps), data.epoch(CNN_BATCH, 0))]
    return cnn_steps(torch, build, step, state, batches, profile_step)


def cnn_pipe_run(torch, data, params, name, build, steps=CNN_PIPE_STEPS,
                 profile_step=None):
    """``steps`` pipeline steps of the homogeneous CNN under run ``name``."""
    from repro_torch.optim.optimizers import init_opt_state
    from repro_torch.train.steps import make_cnn_train_step
    sched, pname = name.split("/")
    opt = cnn_opt(CNN_PIPE_BATCH)
    step = make_cnn_train_step(cnn_policy(pname, CNN_PIPE_STAGES), opt,
                               transport="pipeline",
                               pipeline_microbatches=CNN_PIPE_MB,
                               schedule=sched)
    batches = [b for _, b in zip(range(steps),
                                 data.epoch(CNN_PIPE_BATCH, 0))]
    return cnn_steps(torch, build, step,
                     (params, init_opt_state(opt, params), []), batches,
                     profile_step)


def cnn_expected_wire(name):
    """Bytes and hops per step of pipeline run ``name`` from
    ``wire_telemetry``, checked against the payload sizes of one
    (32, 32, 32, 64) f32 microbatch."""
    from repro_torch.transport.pipeline import (PipelineTransport,
                                                wire_telemetry)
    from repro_torch.transport.schedules import get_schedule
    from repro_torch.train.steps import _uniform_boundary
    sched, pname = name.split("/")
    schedule = get_schedule(sched, 1)
    tel = wire_telemetry(
        PipelineTransport(
            _uniform_boundary(cnn_policy(pname, CNN_PIPE_STAGES)),
            CNN_PIPE_STAGES, fused=schedule.fused_wire),
        schedule, (CNN_HOP[0], 32, 32, CNN_WIDTH),
        microbatches=CNN_PIPE_MB)
    hops = CNN_PIPE_MB * tel["wire_cuts"]
    fw, bw = CNN_PIPE_RUNS[name][1]
    assert hops == PIPE_HOPS, (name, hops)
    assert tel["fw_payload_bytes_per_hop"] == CNN_PAYLOAD[fw], (name, tel)
    assert tel["bw_payload_bytes_per_hop"] == CNN_PAYLOAD[bw], (name, tel)
    return {"fw_hops": hops, "bw_hops": hops,
            "fw_bytes": hops * tel["fw_payload_bytes_per_hop"],
            "bw_bytes": hops * tel["bw_payload_bytes_per_hop"]}


def cnn_profile(torch, run, unprofiled_s, what):
    dev = sorted(device_records(run["profile"]), reverse=True)
    busy_ms = sum(ms for ms, _ in dev)
    wall_ms = run["seconds"][-1] * 1e3
    step_ms = 1e3 * unprofiled_s
    log(f"# cnn {what} profile " + json.dumps({
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1 - busy_ms / wall_ms,
        "unprofiled_step_ms": step_ms,
        "device_idle_share_unprofiled": 1 - busy_ms / step_ms,
        "top_device_ms": [[key[:60], ms] for ms, key in dev[:6]]}))


def cnn(torch, D, build):
    """The CNN path: ResNet18 through simulated cuts, the homogeneous CNN
    through the real pipeline, evaluation with compression on and off and
    ``run_cnn_experiment`` per transport, all on the card."""
    from repro_torch.data.synthetic import ImageClassData
    from repro_torch.models import cnn as C
    from repro_torch.train.loop import _cnn_eval, run_cnn_experiment

    log("# cnn precision: convs in "
        f"{'TF32' if torch.backends.cudnn.allow_tf32 else 'float32'} "
        f"(torch.backends.cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32}, the default), the head's "
        "matmul and the 1x1 projections in "
        f"{'TF32' if torch.backends.cuda.matmul.allow_tf32 else 'float32'}"
        " (torch.backends.cuda.matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32}), all else float32")
    data = ImageClassData()
    params = C.init_params(torch.Generator(device="cuda").manual_seed(0),
                           width=CNN_WIDTH)
    pparams = C.init_pipeline_params(
        torch.Generator(device="cuda").manual_seed(0), CNN_PIPE_STAGES,
        width=CNN_WIDTH)
    build.reset_launches()                  # the CNN paths start here
    runs = {name: cnn_run(torch, data, params, name, build)
            for name in CNN_POLICIES}
    pipes = {name: cnn_pipe_run(torch, data, pparams, name, build)
             for name in CNN_PIPE_RUNS}
    evals = {}
    for compress, want in ((True, 3 * (CNN_TEST // CNN_BATCH)), (False, 0)):
        before = build.LAUNCHES.get("topk_block", 0)
        evals[compress] = _cnn_eval(runs["top10"]["params"], data,
                                    cnn_policy("top10"), compress, CNN_BATCH,
                                    "simulated", device="cuda")
        got = build.LAUNCHES.get("topk_block", 0) - before
        if got != want or not all(map(math.isfinite, evals[compress])):
            raise AssertionError(f"cnn eval compress={compress}: {got} "
                                 f"launches (want {want}), {evals[compress]}")
    exps = {}
    for transport, name, kw, per_step, per_eval in (
            ("simulated", "top10", dict(batch=CNN_BATCH),
             dict(topk_block=6), dict(topk_block=3)),
            ("pipeline", "q4q8", dict(batch=CNN_PIPE_BATCH,
                                      pipeline_microbatches=CNN_PIPE_MB),
             _Q4Q8, dict(quant_dequant=3))):
        before = dict(build.LAUNCHES)
        t0 = time.perf_counter()
        res = run_cnn_experiment(cnn_policy(name), epochs=1, width=CNN_WIDTH,
                                 data=data, transport=transport, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        # each step, then the compressed eval over the test batches
        steps = CNN_TRAIN // kw["batch"]
        evals_n = CNN_TEST // kw["batch"]
        want = {k: steps * per_step.get(k, 0) + evals_n * per_eval.get(k, 0)
                for k in KERNELS}
        got = {k: build.LAUNCHES.get(k, 0) - before.get(k, 0)
               for k in KERNELS}
        if got != want:
            raise AssertionError(f"run_cnn_experiment {transport}: launches "
                                 f"{got}, expected {want}")
        vals = (res.acc_on, res.acc_off, res.loss_on, res.loss_off)
        if not (all(map(math.isfinite, vals))
                and 0 <= res.acc_on <= 100 and 0 <= res.acc_off <= 100):
            raise AssertionError(f"run_cnn_experiment {transport}: {vals}")
        exps[transport] = {"policy": name, "steps": steps,
                           "acc_on": res.acc_on, "acc_off": res.acc_off,
                           "loss_on": res.loss_on, "loss_off": res.loss_off,
                           "train_curve": res.train_curve,
                           "seconds_train": res.seconds,
                           "seconds_with_eval": secs,
                           "launches": {k: v for k, v in got.items() if v}}
    torch.cuda.synchronize()
    launches = {k: build.LAUNCHES.get(k, 0) for k in KERNELS}  # read here
    log(f"# cnn-path launches {launches}")

    for name, (kernel, per_step) in CNN_POLICIES.items():
        run = runs[name]
        want = _per_step(**({kernel: per_step} if kernel else {}))
        for i, got in enumerate(run["launches"]):
            if got != want:
                raise AssertionError(f"cnn {name} step {i + 1}: launches "
                                     f"{got}, expected {want}")
        # finite, but not falling: the reference's default SGD (lr 0.02,
        # momentum 0.9, no warmup) raises a full-width ResNet18's loss over
        # its first steps; the CPU tests hold each step to the reference's
        losses = run["losses"]
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"cnn {name}: non-finite loss {losses}")
        log("# cnn " + json.dumps({
            "policy": name, "losses": losses,
            "launches_per_step": {k: v for k, v in run["launches"][0].items()
                                  if v},
            "step_s": run["seconds"],
            "images_per_s_steps_2_to_4": CNN_BATCH * (CNN_STEPS - 1)
            / sum(run["seconds"][1:])}))
    for name, (want, _) in CNN_PIPE_RUNS.items():
        run = pipes[name]
        wire = cnn_expected_wire(name)
        for i, (got, got_wire) in enumerate(zip(run["launches"],
                                                run["wire"])):
            if got != want:
                raise AssertionError(f"cnn pipeline {name} step {i + 1}: "
                                     f"launches {got}, expected {want}")
            if got_wire != wire:
                raise AssertionError(f"cnn pipeline {name} step {i + 1}: "
                                     f"wire {got_wire}, expected {wire}")
        if not all(math.isfinite(v) for v in run["losses"]):
            raise AssertionError(f"cnn pipeline {name}: {run['losses']}")
        if name in CNN_FALLING and not run["losses"][-1] < run["losses"][0]:
            raise AssertionError(f"cnn pipeline {name}: the loss does not "
                                 f"fall {run['losses']}")
        log("# cnn pipeline " + json.dumps({
            "run": name, "losses": run["losses"],
            "launches_per_step": {k: v for k, v in run["launches"][0].items()
                                  if v},
            "wire_per_step": run["wire"][0], "step_s": run["seconds"],
            "images_per_s_steps_2_to_3": CNN_PIPE_BATCH * (CNN_PIPE_STEPS - 1)
            / sum(run["seconds"][1:])}))
    a, b = pipes["gpipe/q4q8"], pipes["1f1b/q4q8"]
    if a["losses"] != b["losses"] or not all(
            torch.equal(x, y) for (_, x), (_, y)
            in zip(_leaves(a["params"]), _leaves(b["params"]), strict=True)):
        raise AssertionError(f"cnn 1f1b != gpipe: {b['losses']} vs "
                             f"{a['losses']}")
    log("# cnn pipeline: 1f1b equals gpipe bitwise (losses and params after "
        f"{CNN_PIPE_STEPS} steps) under q4q8")
    log("# cnn eval of the top10 model, 500 test images " + json.dumps(
        {"acc_on": evals[True][0], "loss_on": evals[True][1],
         "acc_off": evals[False][0], "loss_off": evals[False][1],
         "launches_on": 3 * (CNN_TEST // CNN_BATCH), "launches_off": 0}))
    for transport, row in exps.items():
        log(f"# cnn run_cnn_experiment {transport} " + json.dumps(row))

    D.KERNEL_BACKEND = "plain"
    try:
        for name in CNN_POLICIES:
            plain = cnn_run(torch, data, params, name, build)["losses"]
            if plain != runs[name]["losses"]:
                raise AssertionError(f"cnn {name}: plain backend losses "
                                     f"{plain} != {runs[name]['losses']}")
        for name in CNN_PIPE_RUNS:
            plain = cnn_pipe_run(torch, data, pparams, name, build)["losses"]
            if plain != pipes[name]["losses"]:
                raise AssertionError(f"cnn pipeline {name}: plain backend "
                                     f"losses {plain} != "
                                     f"{pipes[name]['losses']}")
    finally:
        D.KERNEL_BACKEND = "auto"
    log("# plain backend on the card gives identical CNN losses for every "
        "simulated and pipeline run")

    check_cnn_against_cpu(torch, C, data)
    for name in CNN_POLICIES:
        prof = cnn_run(torch, data, params, name, build, steps=2,
                       profile_step=2)
        cnn_profile(torch, prof, sorted(runs[name]["seconds"][1:])[1],
                    f"simulated {name}")
    prof = cnn_pipe_run(torch, data, pparams, "gpipe/q4q8", build, steps=2,
                        profile_step=2)
    cnn_profile(torch, prof, min(pipes["gpipe/q4q8"]["seconds"][1:]),
                "pipeline gpipe/q4q8")
    return launches


def check_cnn_against_cpu(torch, C, data):
    """One uncompressed step of a width-8 ResNet on the card and on the
    CPU (which the CPU tests hold to the JAX package): the loss, the
    updated params and the gradient the optimizer was given.  Convs in
    TF32 (the default): loss and params within ``CNN_TF32_ATOL``, the
    gradient tree and each leaf within ``CNN_TF32_GRAD_RTOL`` of its
    norm; with TF32 off, ``CNN_F32_ATOL`` and ``CNN_F32_GRAD_RTOL``."""
    import repro_torch.train.steps as TS
    from repro_torch.optim.optimizers import init_opt_state
    params = C.init_params(torch.Generator().manual_seed(1), width=8)
    opt = cnn_opt(16)
    step = TS.make_cnn_train_step(cnn_policy("none"), opt)
    x, y, ids = next(data.epoch(16, 0))
    out = {}
    tf32 = torch.backends.cudnn.allow_tf32
    for dev, allow_tf32 in (("cpu", tf32), ("cuda", True), ("cuda", False)):
        torch.backends.cudnn.allow_tf32 = allow_tf32
        args = [torch.from_numpy(a).to(dev) for a in (x, y, ids)]
        p, grads = _tree_to(params, dev), []
        try:
            with first_gradient(grads):
                new, _, _, m = step(p, init_opt_state(opt, p), [], *args)
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        out[(dev, allow_tf32)] = (float(m["loss"]), _tree_to(new, "cpu"),
                                  _tree_to(grads[0], "cpu"))
    cpu_loss, cpu_params, cpu_grads = out[("cpu", tf32)]
    for allow_tf32, tol, rtol in ((True, CNN_TF32_ATOL, CNN_TF32_GRAD_RTOL),
                                  (False, CNN_F32_ATOL, CNN_F32_GRAD_RTOL)):
        loss, new, grads = out[("cuda", allow_tf32)]
        gap = max(abs(loss - cpu_loss), max(
            (a - b).abs().max().item() for (_, a), (_, b)
            in zip(_leaves(new), _leaves(cpu_params), strict=True)))
        pairs = [(k, a, b) for (k, a), (_, b)
                 in zip(_leaves(grads), _leaves(cpu_grads), strict=True)]
        rel = {k: ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
               for k, a, b in pairs}
        whole = tree_rel_gap(grads, cpu_grads)
        order = sorted(rel, key=rel.get, reverse=True)
        prec = "TF32" if allow_tf32 else "float32"
        if not (math.isfinite(loss) and gap <= tol and whole <= rtol[0]
                and all(math.isfinite(v) and v <= rtol[1]
                        for v in rel.values())):
            raise AssertionError(f"smoke CNN step, convs {prec}: card loss "
                                 f"{loss} vs CPU {cpu_loss}, gap {gap}, "
                                 f"gradient off by {whole} of its norm, "
                                 f"leaf {order[0]} by {rel[order[0]]}")
        log(f"# smoke CNN step (width 8, batch 16), convs {prec}, card vs "
            f"CPU: loss {loss} vs {cpu_loss}, max gap over the loss and "
            f"every updated param {gap} (<= {tol}); gradient: "
            f"|card - CPU| / |CPU| {whole} (<= {rtol[0]}), per leaf (<= "
            f"{rtol[1]}) largest " + json.dumps(
                [[k, rel[k]] for k in order[:4]])
            + f", median {rel[order[len(order) // 2]]}")


# ---------------------------------------------------------------------------
# phase 8: the pipeline x DP step (the 2D data x stage grid)
# ---------------------------------------------------------------------------

def pd_stages(name):
    """(stages, virtual stages) of a phase 8 run."""
    v = PD_RUNS[name][3]
    return PD_STAGES // v, v


def pd_policy(name):
    import dataclasses
    from repro_torch.launch.train import build_policy
    pname, feedback = PD_RUNS[name][:2]
    return dataclasses.replace(build_policy(pname, feedback, 0.1),
                               num_stages=pd_stages(name)[0])


def pd_run(torch, cfg, params, name, build, steps=PD_STEPS,
           profile_step=None, smi=""):
    """``steps`` pipeline x DP train steps of run ``name`` from
    ``params``, built as ``launch/train --mesh data=2,stage=S --wire
    data=...`` builds its run.  Returns the losses, each step's launches,
    wire counters and wall seconds, the final params and the profile of
    ``profile_step``."""
    from repro_torch.core.parallel import AxisSpec, ParallelSpec
    from repro_torch.launch.train import synthetic_stream
    from repro_torch.optim.optimizers import OptimizerConfig, init_opt_state
    from repro_torch.train.loop import _pipeline_bstates, init_lm_dp_state
    from repro_torch.train.steps import make_lm_train_step

    _, _, sched, _, codec, dfb, k_frac = PD_RUNS[name]
    stages, v = pd_stages(name)
    policy = pd_policy(name)
    spec = ParallelSpec({"data": AxisSpec(size=PD_DP, codec=codec,
                                          feedback=dfb, k_frac=k_frac),
                         "stage": stages})
    opt = OptimizerConfig(kind="adamw", lr=1e-3, weight_decay=0.01,
                          schedule="cosine", t_max=steps, grad_clip=1.0)
    bstates = _pipeline_bstates(policy, (PD_SEQ, cfg.d_model),
                                batch=PD_BATCH, microbatches=PD_MB,
                                num_samples=PD_SAMPLES,
                                dtype=torch.bfloat16, virtual_stages=v,
                                dp=PD_DP, device="cuda")
    dp_state = init_lm_dp_state(cfg, params, policy, PD_DP, dfb,
                                transport="pipeline", virtual_stages=v)
    step = make_lm_train_step(cfg, policy, opt, transport="pipeline",
                              pipeline_microbatches=PD_MB, schedule=sched,
                              virtual_stages=v, parallel=spec)
    stream = synthetic_stream(cfg, PD_BATCH, PD_SEQ, 0,
                              num_samples=PD_SAMPLES, dp=PD_DP)
    opt_state = init_opt_state(opt, params)
    out = {"losses": [], "launches": [], "wire": [], "seconds": [],
           "profile": None}
    for i in range(1, steps + 1):
        toks, ids = next(stream)
        batch = {"tokens": torch.from_numpy(toks).to("cuda", torch.int64)}
        ids = torch.from_numpy(ids).to("cuda")
        before = dict(build.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        args = (params, opt_state, bstates, batch, ids, dp_state)
        if i == profile_step:
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                params, opt_state, bstates, dp_state, m = step(*args)
                torch.cuda.synchronize()
            out["profile"] = prof
        else:
            params, opt_state, bstates, dp_state, m = step(*args)
            torch.cuda.synchronize()
        out["seconds"].append(time.perf_counter() - t0)
        out["losses"].append(float(m["loss"]))
        out["wire"].append(m["wire"])
        out["launches"].append({k: build.LAUNCHES.get(k, 0) - before.get(k, 0)
                                for k in KERNELS})
    out["params"] = params
    return out


def pd_expected(name, params):
    """Launches, hops and bytes per step of run ``name``, worked out from
    its parts: each replica row's hops from ``wire_telemetry`` (x dp
    rows), and the ring from ``dp_wire_report(shard_axis=S)`` of the
    layer stack (S columns of dp (dp - 1) hops of one column's payload).
    Launches: the hop codec's per hop and direction (q4 forward: the q4
    pair; q8 backward: ``quantize_wire`` where the hop fills (8, n) wire
    tiles, none at 4 rows, which pack per tensor; TopK: the select, both
    directions; a fused schedule frames and unframes every hop); the
    ring's per column (q8: a framing launch a replica and one decode; q4
    also packs every leaf a replica, and with EF21 unpacks its own;
    TopK: the select on every leaf a replica and framing both ways a
    replica; raw: framing both ways a replica)."""
    from repro_torch.models import transformer
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.transport.collectives import dp_wire_report
    from repro_torch.transport.pipeline import (PipelineTransport,
                                                wire_telemetry)
    from repro_torch.transport.schedules import get_schedule
    from repro_torch.kernels.tiling import wire_tiling
    from repro_torch.train.steps import _uniform_boundary
    pname, feedback, sched, _, codec, dfb, k_frac = PD_RUNS[name]
    stages, v = pd_stages(name)
    bp = _uniform_boundary(pd_policy(name))
    schedule = get_schedule(sched, v)
    tel = wire_telemetry(PipelineTransport(bp, stages, virtual_stages=v,
                                           fused=schedule.fused_wire),
                         schedule, (PD_HOP[0], PD_SEQ, D_MODEL),
                         microbatches=PD_MB)
    hops = PD_DP * PD_MB * tel["wire_cuts"]
    assert hops == PD_HOPS, (name, hops)
    launches = dict.fromkeys(KERNELS, 0)
    for comp in (bp.fw, bp.bw):                 # each direction's codec
        if comp.kind == "quant" and comp.bits == 4:
            launches["pack4_wire"] += hops
            launches["unpack4_wire"] += hops
        elif comp.kind == "quant" and wire_tiling(PD_HOP) is not None:
            launches["quantize_wire"] += hops   # q8 in (8, n) tiles
        elif comp.kind == "topk":
            launches["topk_threshold"] += hops
            launches["topk_compact"] += hops
    if schedule.fused_wire:
        launches["frame_parts"] += 2 * hops
        launches["unframe_parts"] += 2 * hops
    stack = transformer.stack_layer_stages(params, stages * v)
    n_leaves = len(tree_leaves(stack))
    rep = dp_wire_report(stack, codec, k_frac=k_frac, dp=PD_DP,
                         shard_axis=stages)
    ring_bytes = rep["columns"] * PD_DP * rep["wire_bytes_per_reduce"]
    for _ in range(rep["columns"]):
        launches["frame_parts"] += PD_DP
        if codec in ("q8", "q4"):
            launches["decode_sum_fused"] += 1
        else:
            launches["unframe_parts"] += PD_DP
        if codec == "q4":
            launches["pack4_wire"] += PD_DP * n_leaves
            if dfb == "ef21":
                launches["unpack4_wire"] += PD_DP * n_leaves
        if codec == "topk":
            launches["topk_threshold"] += PD_DP * n_leaves
            launches["topk_compact"] += PD_DP * n_leaves
    wire = {"fw_hops": hops, "bw_hops": hops,
            "fw_bytes": hops * tel["fw_payload_bytes_per_hop"],
            "bw_bytes": hops * tel["bw_payload_bytes_per_hop"],
            "dp_hops": stages * PD_DP * (PD_DP - 1), "dp_bytes": ring_bytes}
    return launches, wire


def pipeline_dp(torch, D, build, smi):
    from repro_torch.configs.registry import get
    from repro_torch.models import transformer

    cfg = get("gpt2-small")
    params = transformer.init_params(
        torch.Generator(device="cuda").manual_seed(0), cfg)
    build.reset_launches()                  # the pipeline x DP path starts
    runs, grad_a = {}, []
    for name in PD_RUNS:
        with first_gradient(grad_a if name == "gpipe/none/none" else []):
            runs[name] = pd_run(torch, cfg, params, name, build)
    torch.cuda.synchronize()
    launches = {k: build.LAUNCHES.get(k, 0) for k in KERNELS}  # read here
    log(f"# pipeline x DP path launches {launches}")
    for name in PD_RUNS:
        run = runs[name]
        want, wire = pd_expected(name, params)
        for i, got in enumerate(run["launches"]):
            if got != want:
                raise AssertionError(f"pipeline x DP {name} step {i + 1}: "
                                     f"launches {got}, expected {want}")
        for i, got in enumerate(run["wire"]):
            if got != wire:
                raise AssertionError(f"pipeline x DP {name} step {i + 1}: "
                                     f"wire {got}, expected {wire}")
        losses = run["losses"]
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"pipeline x DP {name}: non-finite loss "
                                 f"{losses}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"pipeline x DP {name}: loss did not fall "
                                 f"{losses}")
        tok_s = (PD_BATCH * PD_SEQ * (PD_STEPS - 1)
                 / sum(run["seconds"][1:]))
        log("# pipeline x DP " + json.dumps({
            "run": name, "card": smi, "losses": losses,
            "launches_per_step": {k: x for k, x in run["launches"][0].items()
                                  if x},
            "wire_per_step": run["wire"][0], "step_s": run["seconds"],
            "tokens_per_s_steps_2_to_3": tok_s}))

    # (a) against the dp = 1 pipeline on the same batch: its 8
    # microbatches of 4 are the hop tensors of the two rows' 4 each
    grad_solo = []
    with first_gradient(grad_solo):
        solo = pd_solo(torch, cfg, params)
    gaps = [abs(a - b) / abs(b) for a, b in
            zip(runs["gpipe/none/none"]["losses"], solo)]
    # step 1's gradient: the stack's is the reduced sum of the two rows'
    grad_gaps = {"tree": tree_rel_gap(grad_a[0], grad_solo[0]),
                 "stack": tree_rel_gap(grad_a[0]["layers"],
                                       grad_solo[0]["layers"])}
    del grad_a, grad_solo
    log("# pipeline x DP gpipe/none/none vs the dp = 1 pipeline (8 "
        "microbatches of 4) " + json.dumps({
            "card": smi, "dp2": runs["gpipe/none/none"]["losses"],
            "dp1": solo, "relative_gap": gaps,
            "bounds": [PD_REL_1] + [PD_REL_N] * (PD_STEPS - 1),
            "step_1_gradient_relative_gap": grad_gaps,
            "gradient_bound": PD_GRAD_REL}))
    if not (gaps[0] <= PD_REL_1 and all(g <= PD_REL_N for g in gaps[1:])
            and all(g <= PD_GRAD_REL for g in grad_gaps.values())):
        raise AssertionError(f"pipeline x DP (a) vs dp = 1: relative loss "
                             f"gaps {gaps}, step 1 gradient {grad_gaps}")

    name = "gpipe/q4q8/q8"
    D.KERNEL_BACKEND = "plain"
    try:
        plain = pd_run(torch, cfg, params, name, build)["losses"]
    finally:
        D.KERNEL_BACKEND = "auto"
    if plain != runs[name]["losses"]:
        raise AssertionError(f"pipeline x DP {name}: plain backend losses "
                             f"{plain} != {runs[name]['losses']}")
    log(f"# plain backend on the card gives identical pipeline x DP losses "
        f"under {name}: {plain}")

    check_pipeline_dp_against_cpu(torch, transformer, get)
    check_launcher_2d(smi)
    prof = pd_run(torch, cfg, params, name, build, steps=2, profile_step=2)
    dev = sorted(device_records(prof["profile"]), reverse=True)
    busy_ms = sum(ms for ms, _ in dev)
    wall_ms = prof["seconds"][1] * 1e3
    step_ms = 1e3 * min(runs[name]["seconds"][1:])
    log("# pipeline x DP profile " + json.dumps({
        "run": name, "card": smi, "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1 - busy_ms / wall_ms,
        "unprofiled_step_ms": step_ms,
        "device_idle_share_unprofiled": 1 - busy_ms / step_ms,
        "top_device_ms": [[key[:60], ms] for ms, key in dev[:8]]}))
    return launches


def pd_solo(torch, cfg, params):
    """Run (a)'s losses from the dp = 1 pipeline: 4 stages, the global
    batch as 8 microbatches of 4."""
    import dataclasses
    from repro_torch.launch.train import build_policy, synthetic_stream
    from repro_torch.optim.optimizers import OptimizerConfig, init_opt_state
    from repro_torch.train.steps import make_lm_train_step
    policy = dataclasses.replace(build_policy("none", "none", 0.1),
                                 num_stages=PD_STAGES)
    opt = OptimizerConfig(kind="adamw", lr=1e-3, weight_decay=0.01,
                          schedule="cosine", t_max=PD_STEPS, grad_clip=1.0)
    step = make_lm_train_step(cfg, policy, opt, transport="pipeline",
                              pipeline_microbatches=PD_DP * PD_MB)
    stream = synthetic_stream(cfg, PD_BATCH, PD_SEQ, 0,
                              num_samples=PD_SAMPLES, dp=PD_DP)
    opt_state, losses = init_opt_state(opt, params), []
    for _ in range(PD_STEPS):
        toks, ids = next(stream)
        params, opt_state, _, m = step(
            params, opt_state, [],
            {"tokens": torch.from_numpy(toks).to("cuda", torch.int64)},
            torch.from_numpy(ids).to("cuda"))
        losses.append(float(m["loss"]))
    return losses


def check_pipeline_dp_against_cpu(torch, transformer, get):
    """One pipeline x DP step of the smoke model (4 layer groups, dp 2 x
    2 stages, batch 16 x 32, 2 microbatches a row) on the card and on the
    CPU, which the CPU tests hold to the JAX package: runs (b) (q4q8 cuts,
    DP q8) and (c) (EF21 TopK 10% cuts, DP q4 + EF21).  It holds the loss
    (the forward pass) within
    ``check_pipeline_against_cpu``'s compressed bound, and the gradient
    (the backward pass, the stage-column reduce of the stack's and its
    fold into ``params["layers"]``): the whole tree and the stack's alone
    within ``PD_CPU_GRAD_RTOL[policy]`` of their norms."""
    import dataclasses
    import numpy as np
    import repro_torch.train.steps as TS
    from repro_torch.core.parallel import AxisSpec, ParallelSpec
    from repro_torch.launch.train import build_policy
    from repro_torch.optim.optimizers import OptimizerConfig, init_opt_state
    from repro_torch.train.loop import _pipeline_bstates, init_lm_dp_state
    cfg = dataclasses.replace(get("gpt2-small", smoke=True), num_layers=4)
    params = transformer.init_params(torch.Generator().manual_seed(1), cfg)
    opt = OptimizerConfig(kind="adamw", lr=1e-3, weight_decay=0.01,
                          schedule="cosine", t_max=1, grad_clip=1.0)
    toks = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.vocab_size, (16, 32)))
    for pname, codec, dfb in (("q4q8", "q8", "none"),
                              ("ef21top10", "q4", "ef21")):
        policy = dataclasses.replace(build_policy(pname, "none", 0.1),
                                     num_stages=2)
        spec = ParallelSpec({"data": AxisSpec(size=2, codec=codec,
                                              feedback=dfb), "stage": 2})
        out = {}
        for dev in ("cpu", "cuda"):
            p = _tree_to(params, dev)
            st = _pipeline_bstates(policy, (32, cfg.d_model), batch=16,
                                   microbatches=2, dtype=torch.bfloat16,
                                   dp=2, device=dev)
            dst = init_lm_dp_state(cfg, p, policy, 2, dfb,
                                   transport="pipeline")
            step = TS.make_lm_train_step(cfg, policy, opt,
                                         transport="pipeline",
                                         pipeline_microbatches=2,
                                         parallel=spec)
            grads = []
            with first_gradient(grads):
                *_, m = step(p, init_opt_state(opt, p), st,
                             {"tokens": toks.to(dev)},
                             torch.arange(16, device=dev), dst)
            out[dev] = (float(m["loss"]), _tree_to(grads[0], "cpu"))
        (loss, grads), (cpu_loss, cpu_grads) = out["cuda"], out["cpu"]
        gap = abs(loss - cpu_loss)
        rel = tree_rel_gap(grads, cpu_grads)
        rel_stack = tree_rel_gap(grads["layers"], cpu_grads["layers"])
        rtol = PD_CPU_GRAD_RTOL[pname]
        what = f"smoke pipeline x DP step {pname} + DP {codec}+{dfb}"
        if not (math.isfinite(loss) and gap <= LM_LOSS_ATOL
                and rel <= rtol and rel_stack <= rtol):
            raise AssertionError(f"{what}: card loss {loss} vs CPU "
                                 f"{cpu_loss}; gradient off by {rel} of "
                                 f"its norm, the stack's by {rel_stack}")
        log(f"# {what}, card vs CPU: loss {loss} vs {cpu_loss}, gap {gap} "
            f"(<= {LM_LOSS_ATOL}); gradient |card - CPU| / |CPU| {rel}, "
            f"the reduced stack's {rel_stack} (<= {rtol})")


def check_launcher_2d(smi):
    """``launch/train --mesh data=2,stage=4 --wire data=q8 --policy q4q8``
    for 2 steps at full width exits 0 with finite losses."""
    argv = [sys.executable, "-m", "repro_torch.launch.train", "--mesh",
            "data=2,stage=4", "--wire", "data=q8", "--policy", "q4q8",
            "--steps", "2", "--batch", str(PD_BATCH), "--seq", str(PD_SEQ),
            "--pipeline-microbatches", str(PD_MB), "--log-every", "1"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    recs = [json.loads(ln) for ln in proc.stdout.splitlines()
            if ln.startswith("{")]
    if (proc.returncode != 0 or [r["step"] for r in recs] != [1, 2]
            or not all(math.isfinite(r["loss"]) for r in recs)):
        raise AssertionError(f"launch/train --mesh data=2,stage=4 exited "
                             f"{proc.returncode}: {proc.stdout[-2000:]}"
                             f"{proc.stderr[-2000:]}")
    log("# launch/train --mesh data=2,stage=4 --wire data=q8 --policy q4q8 "
        "exits 0: " + json.dumps({"card": smi, "steps": recs}))


# ---------------------------------------------------------------------------
# phase 9: train state (save, restore, resume) and rule policies
# ---------------------------------------------------------------------------

def _q4ef21_dp(dp):
    """Launches a step of q4 + EF21 DP lanes around the 3 q4q8 cuts."""
    return _per_step(quant_dequant=6 * dp, pack4_wire=dp * LEAVES,
                     unpack4_wire=dp * LEAVES, frame_parts=dp,
                     decode_sum_fused=1)


# case -> (launch/train --policy, --feedback, transport, schedule, global
#          batch, pipeline microbatches (a row), DP codec + feedback or
#          None, AQ-SGD samples, launches per step (None: pd_expected's))
RESUME_CASES = {
    "simulated/aqsgd": ("none", "aqsgd", "simulated", None, TRAIN_BATCH,
                        None, None, AQSGD_SAMPLES, _per_step(topk_block=6)),
    "pipeline/1f1b/ef21top10": ("ef21top10", "none", "pipeline", "1f1b",
                                PIPE_BATCH, PIPE_MB, None, PIPE_SAMPLES,
                                _per_step(**_TOPK, **_FRAMED)),
    "dp/q4+ef21/q4q8": ("q4q8", "none", "simulated", None, 2 * TRAIN_BATCH,
                        None, ("q4", "ef21"), AQSGD_SAMPLES, _q4ef21_dp(2)),
    "pipeline x dp/gpipe/ef21top10/q4+ef21": (
        "ef21top10", "none", "pipeline", "gpipe", PD_BATCH, PD_MB,
        ("q4", "ef21"), PD_SAMPLES, None),
}
RESUME_STEPS, RESUME_AT = 4, 2
LM_RULES = "topk:0.1@depth<1,dir=fw;q4@dir=bw;q8"
CNN_RULES = "topk:0.1@size>=65536;q4@size>=32768;q8"
WIRE_RULES = "data=q4@size>=100000000;q8"


def state_case(torch, cfg, case, policy=None):
    """A phase 9 run as ``launch/train`` builds it: ``(step, fresh,
    dp)``; ``fresh()`` makes its initial state (seed-0 params, AdamW
    state, feedback buffers, DP state) on the card."""
    import dataclasses
    from repro_torch.core.boundary import init_boundary_state
    from repro_torch.core.parallel import AxisSpec, ParallelSpec
    from repro_torch.launch.train import build_policy
    from repro_torch.models import transformer
    from repro_torch.optim.optimizers import OptimizerConfig, init_opt_state
    from repro_torch.train.loop import _pipeline_bstates, init_lm_dp_state
    from repro_torch.train.steps import make_lm_train_step

    pname, fb, transport, sched, batch, mb, dp_wire, samples, _ = case
    if policy is None:
        policy = dataclasses.replace(build_policy(pname, fb, 0.1),
                                     num_stages=4)
    dp = 2 if dp_wire else 1
    axes = {}
    if dp_wire:
        axes["data"] = AxisSpec(size=dp, codec=dp_wire[0],
                                feedback=dp_wire[1])
    if transport == "pipeline":
        axes["stage"] = 4
    opt = OptimizerConfig(kind="adamw", lr=1e-3, weight_decay=0.01,
                          schedule="cosine", t_max=RESUME_STEPS,
                          grad_clip=1.0)
    step = make_lm_train_step(
        cfg, policy, opt, transport=transport, pipeline_microbatches=mb,
        schedule=sched or "gpipe",
        parallel=ParallelSpec(axes) if axes else None)
    feat = (TRAIN_SEQ, cfg.d_model)

    def fresh():
        params = transformer.init_params(
            torch.Generator(device="cuda").manual_seed(0), cfg)
        if transport == "pipeline":
            bst = _pipeline_bstates(policy, feat, batch=batch,
                                    microbatches=mb, num_samples=samples,
                                    dtype=torch.bfloat16, dp=dp,
                                    device="cuda")
        else:
            cuts = len(transformer.segment_bounds(cfg.num_groups,
                                                  policy.num_stages)) - 1
            bst = [init_boundary_state(policy.at(i), feat, batch=batch,
                                       num_samples=samples,
                                       dtype=torch.bfloat16, device="cuda")
                   for i in range(cuts)]
        dps = (init_lm_dp_state(cfg, params, policy, dp, dp_wire[1],
                                transport=transport) if dp_wire else None)
        return {"params": params, "opt": init_opt_state(opt, params),
                "bst": bst, "dp": dps}

    return step, fresh, dp


def state_steps(torch, cfg, case, step, st, start, n, dp, build):
    """``n`` steps of a phase 9 run from state ``st``, the token stream
    from step ``start``.  Returns the losses, each step's launches and the
    new state."""
    from repro_torch.launch.train import synthetic_stream
    batch, samples = case[4], case[7]
    stream = synthetic_stream(cfg, batch, TRAIN_SEQ, 0, num_samples=samples,
                              start_step=start, dp=dp)
    losses, launches = [], []
    for _ in range(n):
        toks, ids = next(stream)
        before = dict(build.LAUNCHES)
        args = [st["params"], st["opt"], st["bst"],
                {"tokens": torch.from_numpy(toks).to("cuda", torch.int64)},
                torch.from_numpy(ids).to("cuda")]
        if st["dp"] is not None:
            args.append(st["dp"])
        out = step(*args)
        st = {"params": out[0], "opt": out[1], "bst": out[2],
              "dp": out[3] if st["dp"] is not None else None}
        losses.append(float(out[-1]["loss"]))
        torch.cuda.synchronize()
        launches.append({k: build.LAUNCHES.get(k, 0) - before.get(k, 0)
                         for k in KERNELS})
    return losses, launches, st


def _state_tree(st):
    feedback = {"boundary": st["bst"]}
    if st["dp"] is not None:
        feedback["dp"] = st["dp"]
    return {"params": st["params"], "opt": st["opt"], "feedback": feedback}


def state_bits_differ(torch, a, b):
    """The keys of two train states whose tensors differ in any bit (or in
    dtype or shape), through the checkpoint's own key walk."""
    from repro_torch.checkpoint.io import _flatten
    fa, fb = _flatten(_state_tree(a)), _flatten(_state_tree(b))
    if sorted(fa) != sorted(fb):
        return sorted(set(fa) ^ set(fb))
    bad = []
    for k, x in fa.items():
        y = fb[k]
        if (x.dtype != y.dtype or x.shape != y.shape
                or x.numel() and not torch.equal(
                    x.contiguous().reshape(-1).view(torch.uint8),
                    y.contiguous().reshape(-1).view(torch.uint8))):
            bad.append(k)
    return bad


def resume_case(torch, cfg, name, build, tmp, smi):
    """Run ``name`` for 4 steps; then again for 2, ``save_train_state``,
    restore into freshly initialised state and run steps 3-4.  Holds the
    losses, the final params, moments and buffers bitwise and the resumed
    steps' launches exact."""
    from repro_torch.checkpoint import io as ckpt_io
    case = RESUME_CASES[name]
    step, fresh, dp = state_case(torch, cfg, case)
    want_losses, want_launches, want = state_steps(
        torch, cfg, case, step, fresh(), 0, RESUME_STEPS, dp, build)
    first, _, mid = state_steps(torch, cfg, case, step, fresh(), 0,
                                RESUME_AT, dp, build)
    path = os.path.join(tmp, "resume.npz")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt_io.save_train_state(path, mid["params"], mid["opt"], mid["bst"],
                             step=RESUME_AT, dp_state=mid["dp"])
    save_s = time.perf_counter() - t0
    nbytes = os.path.getsize(path)
    del mid
    like = fresh()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = ckpt_io.restore_train_state(path, like["params"], like["opt"],
                                      like["bst"], dp_like=like["dp"])
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    os.remove(path)
    back = {"params": out[0], "opt": out[1], "bst": out[2],
            "dp": out[3] if like["dp"] is not None else None}
    del like, out
    rest, launches, got = state_steps(torch, cfg, case, step, back,
                                      RESUME_AT, RESUME_STEPS - RESUME_AT,
                                      dp, build)
    per_step = (case[8] if case[8] is not None else
                pd_expected("gpipe/ef21top10/q4+ef21", got["params"])[0])
    bad = state_bits_differ(torch, got, want)
    if first + rest != want_losses or bad:
        raise AssertionError(f"resume {name}: losses {first + rest} vs "
                             f"{want_losses}; tensors that differ: "
                             f"{bad[:8]} ({len(bad)})")
    for i, got_l in enumerate(want_launches + launches):
        if got_l != per_step:
            raise AssertionError(f"resume {name}: launches {got_l} in run "
                                 f"step {i + 1}, expected {per_step}")
    moved = [k for k, t in _flatten_feedback(got).items()
             if t.numel() and bool(t.ne(0).any())]
    if not moved:
        raise AssertionError(f"resume {name}: no feedback buffer moved")
    log("# resume " + json.dumps({
        "case": name, "card": smi, "losses": want_losses,
        "resumed_losses": first + rest, "bitwise": True,
        "launches_per_step": {k: v for k, v in per_step.items() if v},
        "file_bytes": nbytes, "save_s": save_s, "restore_s": restore_s,
        "buffers_moved": len(moved)}))
    del want, got, back
    torch.cuda.empty_cache()


def _flatten_feedback(st):
    from repro_torch.checkpoint.io import _flatten
    return _flatten(_state_tree(st)["feedback"])


def launchers(argvs):
    """One fresh ``launch/*`` subprocess on the card for each entry of
    ``argvs`` (name -> argv), all started at once."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return {k: subprocess.Popen([sys.executable, "-m", *argv], cwd=ROOT,
                                env=env, text=True, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE)
            for k, argv in argvs.items()}


def launcher_results(procs, timeout=600):
    """Wait for each of ``procs``: name -> (exit code, JSON lines, stdout
    and the tail of stderr)."""
    res = {}
    for k, proc in procs.items():
        out, err = proc.communicate(timeout=timeout)
        recs = [json.loads(ln) for ln in out.splitlines()
                if ln.startswith("{")]
        res[k] = (proc.returncode, recs, out + err[-2000:])
    return res


@contextlib.contextmanager
def reaped(waves: list):
    """Kill whatever subprocess of ``waves`` (dicts of Popen) still runs
    when the block ends: none on success, every one after a failure."""
    try:
        yield waves
    finally:
        for procs in waves:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()


def _loss_lines(recs):
    return [{k: v for k, v in r.items() if k not in ("tok_per_s", "wall_s")}
            for r in recs]


def _resume_argv():
    return ["repro_torch.launch.train", "--feedback", "aqsgd",
            "--num-samples", str(AQSGD_SAMPLES), "--batch", str(TRAIN_BATCH),
            "--seq", str(TRAIN_SEQ), "--log-every", "1", "--steps",
            str(RESUME_STEPS)]


def launcher_wave1(tmp):
    """Phase 9's first wave of launchers, started together: ``launch/train
    --steps 4``; the same run saving its train state every 2 steps (one
    file a save, under ``tmp``); ``--mesh data=2`` with the rule-coded
    ``--wire`` and with ``--wire data=q4``."""
    base = _resume_argv()
    ckpt = os.path.join(tmp, "run_{step}.npz")
    wire = ["repro_torch.launch.train", "--mesh", "data=2", "--policy",
            "q4q8", "--steps", "2", "--batch", str(2 * TRAIN_BATCH), "--seq",
            str(TRAIN_SEQ), "--log-every", "1"]
    return launchers({
        "full": base,
        "saving": base + ["--ckpt", ckpt, "--save-every", str(RESUME_AT)],
        "wire rules": wire + ["--wire", WIRE_RULES],
        "wire q4": wire + ["--wire", "data=q4"]})


def launcher_wave2(tmp, wave1, smi):
    """Checks wave 1: the saving run's lines equal the uninterrupted
    run's and it wrote its step-2 and step-4 files; a rule-coded data
    codec gives the lines of the static codec it resolves to
    (gpt2-small's gradient resolves ``q4@size>=100000000;q8`` to q4).
    Then starts wave 2, which reads wave 1's files: ``--resume`` from the
    step-2 file to step 4 (the cosine schedule spans ``--steps``, so the
    interrupted run is a 4-step run saved at step 2), and ``launch/serve
    --engine static --ckpt`` on the step-4 train-state file (phase 11
    serves a params file through the continuous engine).  Returns
    (wave 2, the uninterrupted run's lines)."""
    res = launcher_results(wave1)
    for k, (rc, recs, tail) in res.items():
        if rc != 0 or not recs:
            raise AssertionError(f"launch/train ({k}) exited {rc}: "
                                 f"{tail[-4000:]}")
    full, saved = (_loss_lines(res[k][1]) for k in ("full", "saving"))
    files = sorted(os.listdir(tmp))
    if (saved != full or files != ["run_2.npz", "run_4.npz"]
            or not all(math.isfinite(r["loss"]) for r in full)):
        raise AssertionError(f"launcher resume: full {full}, saved {saved}, "
                             f"files {files}")
    rules, q4 = (_loss_lines(res[k][1]) for k in ("wire rules", "wire q4"))
    if rules != q4:
        raise AssertionError(f"--wire {WIRE_RULES} {rules} != --wire "
                             f"data=q4 {q4}")
    log(f"# launch/train --wire '{WIRE_RULES}' equals --wire data=q4: "
        + json.dumps({"card": smi, "steps": rules}))
    wave2 = launchers({
        "resumed": _resume_argv() + ["--resume",
                                     os.path.join(tmp, "run_2.npz")],
        "serve": ["repro_torch.launch.serve", "--arch", "gpt2-small",
                  "--engine", "static", "--ckpt",
                  os.path.join(tmp, "run_4.npz"), "--batch", "2",
                  "--prompt-len", "16", "--new-tokens", "4"]})
    return wave2, full


def launcher_resume(tmp, wave2, full, smi):
    """Checks wave 2: the resumed run's lines equal the uninterrupted
    run's steps 3-4, and ``launch/serve --ckpt`` restored the step-4
    params and exited 0.  The launchers share the card with each other
    and with the phase's other runs, so no seconds are printed."""
    res = launcher_results(wave2)
    rc, recs, tail = res["resumed"]
    resumed = _loss_lines(recs)
    if rc != 0 or resumed != full[RESUME_AT:]:
        raise AssertionError(f"launcher resume: exited {rc}, full {full}, "
                             f"resumed {resumed}: {tail[-4000:]}")
    rc, _, tail = res["serve"]
    if rc != 0 or "restored step-4 params" not in tail:
        raise AssertionError(f"launch/serve --ckpt exited {rc}: "
                             f"{tail[-4000:]}")
    log("# launcher resume " + json.dumps({
        "card": smi, "steps": full, "resumed": resumed, "identical": True,
        "train_state_bytes": os.path.getsize(os.path.join(tmp,
                                                          "run_2.npz"))}))
    log("# launch/serve --ckpt <train-state file> exits 0: "
        + json.dumps({"card": smi, "restored": [
            ln for ln in tail.splitlines() if "restored" in ln]}))


def rule_policies(torch, D, cfg, build, smi):
    """The per-cut rule policy on the simulated cuts (exact launches, the
    plain backend's losses), a one-rule q8 set against the static q8
    policy, and ``run_cnn_experiment`` under a per-cut rule policy
    (exact launches a step and a test batch)."""
    from repro_torch.core.policy import (CompressionPolicy,
                                         parse_policy_rules, quant_policy,
                                         resolve_policy)
    from repro_torch.data.synthetic import ImageClassData
    from repro_torch.train.loop import run_cnn_experiment

    case = RESUME_CASES["simulated/aqsgd"]       # its policy replaced
    feat = TRAIN_SEQ * cfg.d_model
    rules = resolve_policy(parse_policy_rules(LM_RULES), feat)
    want = _per_step(quant_dequant=5, topk_block=1)
    losses = {}
    for name, pol in (("rules", rules),
                      ("q8 rule", resolve_policy(parse_policy_rules("q8"),
                                                 feat)),
                      ("q8 static", CompressionPolicy(4,
                                                      quant_policy(8, 8)))):
        step, fresh, dp = state_case(torch, cfg, case, policy=pol)
        losses[name], launches, _ = state_steps(
            torch, cfg, case, step, fresh(), 0, RESUME_STEPS, dp, build)
        if name == "rules" and any(l != want for l in launches):
            raise AssertionError(f"rule policy {LM_RULES}: launches "
                                 f"{launches}, expected {want} a step")
        if not all(map(math.isfinite, losses[name])):
            raise AssertionError(f"{name}: losses {losses[name]}")
    if losses["q8 rule"] != losses["q8 static"]:
        raise AssertionError(f"one-rule q8 {losses['q8 rule']} != static "
                             f"q8 {losses['q8 static']}")
    D.KERNEL_BACKEND = "plain"
    try:
        step, fresh, dp = state_case(torch, cfg, case, policy=rules)
        plain = state_steps(torch, cfg, case, step, fresh(), 0,
                            RESUME_STEPS, dp, build)[0]
    finally:
        D.KERNEL_BACKEND = "auto"
    if plain != losses["rules"]:
        raise AssertionError(f"rule policy: plain backend losses {plain} "
                             f"!= {losses['rules']}")
    log("# rule policy " + json.dumps({
        "spec": LM_RULES, "card": smi, "resolved": rules.name,
        "losses": losses["rules"], "plain_backend_losses_equal": True,
        "launches_per_step": {k: v for k, v in want.items() if v}}))
    log("# one-rule q8 set equals the static q8 policy bitwise: "
        + json.dumps({"card": smi, "losses": losses["q8 rule"]}))

    data = ImageClassData()
    sizes = [32 * 32 * CNN_WIDTH >> s for s in range(3)]
    cnn_pol = resolve_policy(parse_policy_rules(CNN_RULES), sizes)
    before = dict(build.LAUNCHES)
    t0 = time.perf_counter()
    res = run_cnn_experiment(parse_policy_rules(CNN_RULES), epochs=1,
                             width=CNN_WIDTH, data=data, batch=CNN_BATCH)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    steps, evals_n = CNN_TRAIN // CNN_BATCH, CNN_TEST // CNN_BATCH
    # a step: fw and bw at each cut; the compressed eval: fw at each cut
    want = _per_step(topk_block=2 * steps + evals_n,
                     quant_dequant=4 * steps + 2 * evals_n)
    got = {k: build.LAUNCHES.get(k, 0) - before.get(k, 0) for k in KERNELS}
    vals = (res.acc_on, res.acc_off, res.loss_on, res.loss_off)
    if got != want or not all(map(math.isfinite, vals)):
        raise AssertionError(f"run_cnn_experiment {CNN_RULES}: launches "
                             f"{got}, expected {want}; {vals}")
    log("# cnn rule policy run_cnn_experiment " + json.dumps({
        "spec": CNN_RULES, "card": smi, "cut_sizes": sizes,
        "resolved": cnn_pol.name, "policy_curve": res.policy_curve,
        "launches_per_step": {"topk_block": 2, "quant_dequant": 4},
        "launches": {k: v for k, v in got.items() if v},
        "acc_on": res.acc_on, "acc_off": res.acc_off,
        "train_curve": res.train_curve, "seconds_with_eval": secs}))


def train_state(torch, D, build, smi):
    """Phase 9: bitwise resumes of the four state layouts at full width,
    the launcher's resume and serving from its train-state file, the rule
    policies on the LM and the CNN and a rule-coded DP wire.  The six
    launcher subprocesses run in two waves beside the in-process runs:
    the first with the resumes, the second (which reads the first's
    files) with the rule policies."""
    import tempfile
    from repro_torch.configs.registry import get

    cfg = get("gpt2-small")
    build.reset_launches()                  # the phase 9 paths start here
    with tempfile.TemporaryDirectory() as tmp, reaped([]) as waves:
        runs = os.path.join(tmp, "launch")
        os.mkdir(runs)
        waves.append(launcher_wave1(runs))
        for name in RESUME_CASES:
            resume_case(torch, cfg, name, build, tmp, smi)
        wave2, full = launcher_wave2(runs, waves[0], smi)
        waves.append(wave2)
        rule_policies(torch, D, cfg, build, smi)
        torch.cuda.synchronize()
        launches = {k: build.LAUNCHES.get(k, 0) for k in KERNELS}  # here
        log(f"# phase 9 launches {launches}")
        launcher_resume(runs, wave2, full, smi)
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 10: the tensor axis (TP alone, DP x TP, pipeline x TP, 3D)
# ---------------------------------------------------------------------------

def tp_spec(r):
    from repro_torch.core.parallel import AxisSpec, ParallelSpec
    return ParallelSpec({
        "data": AxisSpec(size=r.dp, codec=r.dp_codec, feedback=r.dp_fb),
        "stage": AxisSpec(size=r.stages, codec=r.stage_wire),
        "tensor": AxisSpec(size=r.tp, codec=r.tp_codec, feedback=r.tp_fb)})


def tp_run(torch, cfg, params, name, build, steps=TP_STEPS + 1,
           profile_step=TP_STEPS + 1):
    """``steps`` train steps of run ``name`` from ``params``, built as
    ``launch/train --mesh ...,tensor=T --wire ...`` builds its run (the
    cosine over ``TP_STEPS + 1`` steps).  Returns the losses, each step's
    launches, wire counters and wall seconds, the final params and the
    profile of ``profile_step``."""
    from repro_torch.core.policy import CompressionPolicy
    from repro_torch.launch.train import build_policy, synthetic_stream
    from repro_torch.models.transformer import tp_sites
    from repro_torch.optim.optimizers import OptimizerConfig, init_opt_state
    from repro_torch.train.loop import init_lm_dp_state
    from repro_torch.train.steps import make_lm_train_step
    from repro_torch.transport.tp_collectives import init_tp_state

    r = TP_RUNS[name]
    opt = OptimizerConfig(kind="adamw", lr=1e-3, weight_decay=0.01,
                          schedule="cosine", t_max=TP_STEPS + 1,
                          grad_clip=1.0)
    step = make_lm_train_step(cfg, build_policy(r.policy), opt,
                              pipeline_microbatches=r.mb,
                              schedule=r.schedule, parallel=tp_spec(r))
    extra = []
    if r.dp > 1:
        extra.append(init_lm_dp_state(
            cfg, params, CompressionPolicy(num_stages=r.stages), r.dp,
            r.dp_fb, transport="pipeline" if r.stages > 1 else "simulated",
            tp=r.tp))
    if r.stages == 1:
        extra.append(init_tp_state((r.batch, TP_SEQ, cfg.d_model),
                                   tp_sites(cfg), r.tp_fb, device="cuda"))
    stream = synthetic_stream(cfg, r.batch, TP_SEQ, 0, dp=r.dp)
    opt_state = init_opt_state(opt, params)
    out = {"losses": [], "launches": [], "wire": [], "seconds": [],
           "profile": None}
    for i in range(1, steps + 1):
        toks, ids = next(stream)
        args = (params, opt_state, [],
                {"tokens": torch.from_numpy(toks).to("cuda", torch.int64)},
                torch.from_numpy(ids).to("cuda"), *extra)
        before = dict(build.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == profile_step:
            # the card's activity only: the idle share needs the kernels,
            # and a host trace of a step's ~10^5 ops takes minutes to read
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                res = step(*args)
                torch.cuda.synchronize()
            out["profile"] = prof
        else:
            res = step(*args)
            torch.cuda.synchronize()
        out["seconds"].append(time.perf_counter() - t0)
        params, opt_state, m = res[0], res[1], res[-1]
        extra = list(res[3:-1])
        out["losses"].append(float(m["loss"]))
        out["wire"].append(m["wire"])
        out["launches"].append({k: build.LAUNCHES.get(k, 0) - before.get(k, 0)
                                for k in KERNELS})
    return out


def tp_expected(name, params):
    """Launches, hops and bytes per step of run ``name``, worked out from
    its parts.  The tensor rings: every run of the whole layer stack (a
    lane, or a row's microbatch through the stages) makes ``2 *
    TP_SITES`` all-gathers (the forward gathers, and the backward's of
    the scatters) and as many reduce-scatters; an all-gather packs and
    decodes the tp shards and, fused, frames each rank's buffer once and
    unframes each source's; a reduce-scatter packs and decodes tp^2
    slices and frames the tp (tp - 1) that leave their rank.  A shard
    packs as one (1, n) row, the reference's per-tensor packing: q8 in
    torch ops (one row fills no wire tile), q4 through the pack pair,
    TopK through the select; raw (none) payloads are one leaf, which no
    framing kernel touches.  Bytes: ``tp_wire_report`` (per device, both
    collectives) x ranks x 2 directions x runs.  The stage hops: one a
    rank's shard, from ``wire_telemetry``, as ``pd_expected`` counts
    them; the DP ring: ``dp_wire_report`` of one (stage column, tensor
    coordinate) block, each block a ring of its own."""
    from repro_torch.kernels.tiling import wire_tiling
    from repro_torch.models import transformer
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.train.steps import _resolve_parallel, _uniform_boundary
    from repro_torch.transport.collectives import dp_wire_report
    from repro_torch.transport.pipeline import (PipelineTransport,
                                                wire_telemetry)
    from repro_torch.transport.schedules import get_schedule
    from repro_torch.transport.tp_collectives import tp_wire_report
    from repro_torch.launch.train import build_policy
    r = TP_RUNS[name]
    launches = dict.fromkeys(KERNELS, 0)
    runs = r.dp * r.mb
    rep = tp_wire_report((r.batch // runs, TP_SEQ, D_MODEL), r.tp,
                         r.tp_codec, sites=TP_SITES)
    colls = 2 * TP_SITES * runs
    packs = colls * (r.tp + r.tp ** 2)
    if r.tp_codec == "q4":
        launches["pack4_wire"] += packs
        launches["unpack4_wire"] += packs
    elif r.tp_codec == "topk":
        launches["topk_threshold"] += packs
        launches["topk_compact"] += packs
    if r.tp_codec != "none":
        launches["frame_parts"] += colls * r.tp ** 2
        launches["unframe_parts"] += colls * r.tp ** 2
    wire = {"tp_hops": 2 * colls * r.tp * (r.tp - 1),
            "tp_bytes": runs * 2 * r.tp * rep["wire_bytes_per_forward"]}
    if r.stages > 1:
        _, policy, _ = _resolve_parallel("phase 10", tp_spec(r),
                                         build_policy(r.policy),
                                         "pipeline", {})
        bp = _uniform_boundary(policy)
        schedule = get_schedule(r.schedule, 1)
        shard = (r.batch // runs, TP_SEQ // r.tp, D_MODEL)
        tel = wire_telemetry(PipelineTransport(bp, r.stages,
                                               fused=schedule.fused_wire),
                             schedule, shard, microbatches=r.mb)
        hops = r.dp * r.tp * r.mb * tel["wire_cuts"]
        flat = (shard[0], shard[1] * shard[2])
        for comp in (bp.fw, bp.bw):
            if comp.kind == "quant" and comp.bits == 4:
                launches["pack4_wire"] += hops
                launches["unpack4_wire"] += hops
            elif comp.kind == "quant" and wire_tiling(flat) is not None:
                launches["quantize_wire"] += hops
            elif comp.kind == "topk":
                launches["topk_threshold"] += hops
                launches["topk_compact"] += hops
        if schedule.fused_wire:
            launches["frame_parts"] += 2 * hops
            launches["unframe_parts"] += 2 * hops
        wire.update(fw_hops=hops, bw_hops=hops,
                    fw_bytes=hops * tel["fw_payload_bytes_per_hop"],
                    bw_bytes=hops * tel["bw_payload_bytes_per_hop"])
    if r.dp > 1:
        like = (transformer.stack_layer_stages(params, r.stages)
                if r.stages > 1 else params["layers"])
        ring = dp_wire_report(like, r.dp_codec, dp=r.dp,
                              shard_axis=r.stages if r.stages > 1 else None,
                              tp_axis=r.tp,
                              tp_dims=transformer.tp_param_dims(like))
        blocks = ring.get("columns", 1) * ring["tensor_columns"]
        n_leaves = len(tree_leaves(like))
        for _ in range(blocks):
            launches["frame_parts"] += r.dp
            if r.dp_codec in ("q8", "q4"):
                launches["decode_sum_fused"] += 1
            else:
                launches["unframe_parts"] += r.dp
            if r.dp_codec == "q4":
                launches["pack4_wire"] += r.dp * n_leaves
                if r.dp_fb == "ef21":
                    launches["unpack4_wire"] += r.dp * n_leaves
        wire.update(dp_hops=blocks * r.dp * (r.dp - 1),
                    dp_bytes=blocks * r.dp * ring["wire_bytes_per_reduce"])
    return launches, wire


def tp_solo(torch, cfg, params):
    """The tp = 1 step on t2/none's batch and schedule: (losses, step-1
    gradient)."""
    from repro_torch.core.policy import NO_POLICY
    from repro_torch.launch.train import synthetic_stream
    from repro_torch.optim.optimizers import OptimizerConfig, init_opt_state
    from repro_torch.train.steps import make_lm_train_step
    opt = OptimizerConfig(kind="adamw", lr=1e-3, weight_decay=0.01,
                          schedule="cosine", t_max=TP_STEPS + 1,
                          grad_clip=1.0)
    step = make_lm_train_step(cfg, NO_POLICY, opt)
    stream = synthetic_stream(cfg, 8, TP_SEQ, 0)
    opt_state, losses, grads = init_opt_state(opt, params), [], []
    with first_gradient(grads):
        for _ in range(TP_STEPS):
            toks, ids = next(stream)
            params, opt_state, _, m = step(
                params, opt_state, [],
                {"tokens": torch.from_numpy(toks).to("cuda", torch.int64)},
                torch.from_numpy(ids).to("cuda"))
            losses.append(float(m["loss"]))
    return losses, grads[0]


def tensor_axis(torch, D, build, smi):
    """Phase 10: the four compositions of the tensor axis at full width,
    exact launches and ring bytes, the plain backend's losses, the
    uncompressed ring against tp = 1, the smoke step card vs CPU, and a
    profile of one step per run."""
    from repro_torch.configs.registry import get
    from repro_torch.models import transformer

    cfg = get("gpt2-small")
    params = transformer.init_params(
        torch.Generator(device="cuda").manual_seed(0), cfg)
    t0 = time.perf_counter()
    build.reset_launches()                  # the tensor-axis paths start
    runs, grad_tp = {}, []
    for name in TP_RUNS:
        with first_gradient(grad_tp if name == "t2/none" else []):
            runs[name] = tp_run(torch, cfg, params, name, build)
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    launches = {k: build.LAUNCHES.get(k, 0) for k in KERNELS}  # read here
    log(f"# tensor axis path launches {launches} (runs done at "
        f"{time.perf_counter() - t0:.1f} s)")
    for name, run in runs.items():
        want, wire = tp_expected(name, params)
        for i, got in enumerate(run["launches"]):
            if got != want:
                raise AssertionError(f"tensor axis {name} step {i + 1}: "
                                     f"launches {got}, expected {want}")
        for i, got in enumerate(run["wire"]):
            if got != wire:
                raise AssertionError(f"tensor axis {name} step {i + 1}: "
                                     f"wire {got}, expected {wire}")
        losses = run["losses"]
        if not (all(math.isfinite(x) for x in losses)
                and losses[-1] < losses[0]):
            raise AssertionError(f"tensor axis {name}: losses {losses}")
        r = TP_RUNS[name]
        dev = sorted(device_records(run["profile"]), reverse=True)
        busy_ms = sum(ms for ms, _ in dev)
        if name == "t2/none":       # the raw records against key_averages
            slow = sum(ms for ms, _ in device_events(run["profile"]))
            log(f"# tensor axis {name}: device busy {busy_ms} ms from the "
                f"raw records, {slow} ms from key_averages")
        wall_ms = run["seconds"][-1] * 1e3
        step_ms = 1e3 * min(run["seconds"][1:TP_STEPS])
        log("# tensor axis " + json.dumps({
            "run": name, "card": smi, "losses": losses,
            "launches_per_step": {k: x for k, x in run["launches"][0].items()
                                  if x},
            "wire_per_step": run["wire"][0], "step_s": run["seconds"],
            "tokens_per_s_steps_2_to_3": r.batch * TP_SEQ * (TP_STEPS - 1)
            / sum(run["seconds"][1:TP_STEPS]),
            "profiled_step_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / wall_ms,
            "device_idle_share_unprofiled": 1 - busy_ms / step_ms,
            "top_device_ms": [[key[:60], ms] for ms, key in dev[:6]]}))
        del run["profile"]
    if runs["s4t2/gpipe/q4q8/q4"]["losses"] != \
            runs["s4t2/1f1b/q4q8/q4"]["losses"]:
        raise AssertionError("pipeline x TP: 1f1b losses differ from gpipe")
    log(f"# tensor axis: pipeline x TP 1f1b equals gpipe bitwise (checks "
        f"done at {time.perf_counter() - t0:.1f} s)")

    # t2/none against the tp = 1 step
    solo, grad_solo = tp_solo(torch, cfg, params)
    got = runs["t2/none"]["losses"][:TP_STEPS]
    gaps = [abs(a - b) / abs(b) for a, b in zip(got, solo)]
    grad_gaps = {"tree": tree_rel_gap(grad_tp[0], grad_solo),
                 "stack": tree_rel_gap(grad_tp[0]["layers"],
                                       grad_solo["layers"])}
    del grad_tp, grad_solo
    log("# tensor axis t2/none vs tp = 1 " + json.dumps({
        "card": smi, "tp2": got, "tp1": solo, "relative_gap": gaps,
        "bounds": [TP_REL_1] + [TP_REL_N] * (TP_STEPS - 1),
        "step_1_gradient_relative_gap": grad_gaps,
        "gradient_bound": TP_GRAD_REL}))
    if not (gaps[0] <= TP_REL_1 and all(g <= TP_REL_N for g in gaps[1:])
            and all(g <= TP_GRAD_REL for g in grad_gaps.values())):
        raise AssertionError(f"tensor axis t2/none vs tp = 1: loss gaps "
                             f"{gaps}, step 1 gradient {grad_gaps}")

    D.KERNEL_BACKEND = "plain"
    try:
        for name in TP_LOSSY:
            plain = tp_run(torch, cfg, params, name, build, steps=TP_STEPS,
                           profile_step=None)["losses"]
            if plain != runs[name]["losses"][:TP_STEPS]:
                raise AssertionError(f"tensor axis {name}: plain backend "
                                     f"losses {plain} != "
                                     f"{runs[name]['losses']}")
            log(f"# plain backend on the card gives identical tensor axis "
                f"losses under {name}: {plain} (at "
                f"{time.perf_counter() - t0:.1f} s)")
    finally:
        D.KERNEL_BACKEND = "auto"
    check_tp_against_cpu(torch, transformer, get)
    return launches


def check_tp_against_cpu(torch, transformer, get):
    """One TP step (tp 2) of the smoke model on the card and on the CPU,
    which the CPU tests hold to the JAX package, under the uncompressed
    and the q8 + EF tensor wire: the loss and the gradient the optimizer
    is given (the tree, and the layer stack alone) within ``TP_CPU``."""
    import numpy as np
    import repro_torch.train.steps as TS
    from repro_torch.core.parallel import AxisSpec, ParallelSpec
    from repro_torch.core.policy import NO_POLICY
    from repro_torch.optim.optimizers import OptimizerConfig, init_opt_state
    from repro_torch.transport.tp_collectives import init_tp_state
    cfg = get("gpt2-small", smoke=True)
    params = transformer.init_params(torch.Generator().manual_seed(1), cfg)
    opt = OptimizerConfig(kind="adamw", lr=1e-3, weight_decay=0.01,
                          schedule="cosine", t_max=1, grad_clip=1.0)
    toks = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab_size, (8, 32)))
    for wire, (atol, rtol) in TP_CPU.items():
        codec, _, fb = wire.partition("+")
        spec = ParallelSpec({"tensor": AxisSpec(2, codec, fb or "none")})
        out = {}
        for dev in ("cpu", "cuda"):
            p = _tree_to(params, dev)
            step = TS.make_lm_train_step(cfg, NO_POLICY, opt, parallel=spec)
            grads = []
            with first_gradient(grads):
                *_, m = step(p, init_opt_state(opt, p), [],
                             {"tokens": toks.to(dev)},
                             torch.arange(8, device=dev),
                             init_tp_state((8, 32, cfg.d_model),
                                           transformer.tp_sites(cfg),
                                           fb or "none", device=dev))
            out[dev] = (float(m["loss"]), _tree_to(grads[0], "cpu"))
        (loss, grads), (cpu_loss, cpu_grads) = out["cuda"], out["cpu"]
        gap = abs(loss - cpu_loss)
        rel = tree_rel_gap(grads, cpu_grads)
        rel_stack = tree_rel_gap(grads["layers"], cpu_grads["layers"])
        if not (math.isfinite(loss) and gap <= atol and rel <= rtol
                and rel_stack <= rtol):
            raise AssertionError(f"smoke TP step {wire}: card loss {loss} "
                                 f"vs CPU {cpu_loss}; gradient off by "
                                 f"{rel}, the stack's by {rel_stack}")
        log(f"# smoke TP step tensor={wire}, card vs CPU: loss {loss} vs "
            f"{cpu_loss}, gap {gap} (<= {atol}); gradient |card - CPU| / "
            f"|CPU| {rel}, the stack's {rel_stack} (<= {rtol})")


# ---------------------------------------------------------------------------
# phase 11: continuous serving
# ---------------------------------------------------------------------------

def cs_requests(np, vocab, shared=0):
    """The reference launcher's workload recipe (``launch/serve.py``):
    ``RandomState(0)``, a shared prefix first, then Zipf prompt lengths,
    Zipf max-new-tokens and each request's tail; ``(prompt, max_new,
    seed)`` a request."""
    from repro_torch.launch.serve import zipf_lengths
    rng = np.random.RandomState(0)
    vocab = min(vocab, 1024)
    pre = rng.randint(0, vocab, shared).astype(np.int64)
    plens = zipf_lengths(rng, CS_REQUESTS, 2, CS_PROMPT)
    news = zipf_lengths(rng, CS_REQUESTS, 1, CS_NEW)
    return [(np.concatenate([pre, rng.randint(0, vocab, plens[i])]),
             int(news[i]), i) for i in range(CS_REQUESTS)]


def cs_serve(eng, reqs, eos=None):
    """Submit every request and drain: ({req_id: tokens}, seconds)."""
    t0 = time.perf_counter()
    for prompt, new, seed in reqs:
        eng.submit(prompt, max_new_tokens=new, eos_token=eos, seed=seed)
    out = {r.req_id: r.out.copy() for r in eng.drain()}
    return out, time.perf_counter() - t0


class StreamGaps:
    """An engine's top-2 logit gap at every (request, step) of its greedy
    streams: the engine module's ``sample_tokens`` keeps the last logits,
    the scheduler's ``started`` / ``token`` read the token's own row
    (single ticks only: the multi-tick decode samples ``tick_chunk``
    times before the scheduler sees a token).  Costs one host sync a
    token; only for the reference runs of the near-tie rule."""

    def __init__(self, torch, engine_mod, eng):
        self.gaps, self.tops, self.last = {}, {}, None
        self.mod, self.real = engine_mod, engine_mod.sample_tokens

        def sample(logits, gens, cfg):
            self.last = logits
            return self.real(logits, gens, cfg)

        engine_mod.sample_tokens = sample
        sched = eng.sched
        started, token = sched.started, sched.token

        def gap(slot, row):
            req = sched.slots[slot]
            top2 = torch.topk(self.last[row].float(), 2).values.tolist()
            self.gaps[(req.req_id, len(req.tokens))] = top2[0] - top2[1]
            self.tops[(req.req_id, len(req.tokens))] = top2[0]

        def on_started(slot, tok, now=None):
            gap(slot, 0)
            return started(slot, tok, now)

        def on_token(slot, tok, now=None):
            gap(slot, slot)
            return token(slot, tok, now)

        sched.started, sched.token = on_started, on_token

    def close(self):
        self.mod.sample_tokens = self.real


def cs_gap_run(torch, make, reqs, tops=False):
    """``make(tick_chunk=1)``'s streams and their gaps (see StreamGaps),
    and with ``tops`` each step's top logit too."""
    import repro_torch.serve.engine as E
    eng = make(tick_chunk=1)
    rec = StreamGaps(torch, E, eng)
    try:
        out, _ = cs_serve(eng, reqs)
    finally:
        rec.close()
    return (out, rec.gaps, rec.tops) if tops else (out, rec.gaps)


def bf16_ulp(v: float) -> float:
    """The spacing of bfloat16 numbers at ``|v|`` (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(max(abs(v), 2.0 ** -126))) - 7)


def cs_parts(got, want, gaps, what, smi, tops=None):
    """Streams equal token for token, except a parting at a step where
    the reference stream's top-2 logits are within ``2 * LOGIT_ATOL``
    (the cuBLAS kernel and the attention's shapes differ with the row
    count, so batch-shape changes may break a near-tie either way); later
    tokens of a parted stream are not compared.  ``LOGIT_ATOL`` is about 4
    bf16 ulps at gpt2's |logit| <= 2; given the steps' top logits
    (``tops``), the bound is twice the larger of it and 2 bf16 ulps at
    the top logit: 4 ulps, where gemma2's clean partings reached 3 over
    24 comparisons of 6 seeds (``chip_gemma2_probe.py``, PERF.md).
    Prints every parting with its gap; raises on any other
    difference."""
    parts, equal = [], 0
    for rid, ref in want.items():
        out = got[rid]
        n = min(len(out), len(ref))
        diff = [i for i in range(n) if out[i] != ref[i]]
        if not diff:
            if len(out) != len(ref):
                raise AssertionError(f"{what}: request {rid} lengths "
                                     f"{len(out)} vs {len(ref)}")
            equal += 1
            continue
        i = diff[0]
        g = gaps[(rid, i)]
        bound = 2 * LOGIT_ATOL
        if tops is not None:
            bound = 2 * max(LOGIT_ATOL, 2 * bf16_ulp(tops[(rid, i)]))
        parts.append({"request": rid, "step": i, "gap": g,
                      **({"top": tops[(rid, i)], "bound": bound}
                         if tops is not None else {})})
        if g > bound:
            raise AssertionError(f"{what}: request {rid} parts at step {i} "
                                 f"without a near-tie (gap {g}): {out} vs "
                                 f"{ref}")
    log(f"# continuous {what}: {equal} of {len(want)} streams identical; "
        "partings (each at a near-tie) " + json.dumps(
            {"card": smi, "partings": parts}))
    return parts


def cs_exact(got, want, what):
    for rid, ref in want.items():
        if not np_equal(got[rid], ref):
            raise AssertionError(f"{what}: request {rid} {got[rid]} vs "
                                 f"{ref}")


def np_equal(a, b):
    return len(a) == len(b) and all(int(x) == int(y) for x, y in zip(a, b))


def cs_expected(name, stats, k=0, draft_inserts=0):
    """The launches of one drain: each cut packs once a forward (3 cuts):
    a prefill chunk or an insert, a decode tick (each of a multi-tick
    chunk's), a verification span, and the draft's inserts and ``k``
    proposals a tick."""
    forwards = (stats.get("prefill_chunks", 0) or stats["completed"]) \
        + stats["ticks"] + draft_inserts + k * stats["ticks"]
    n = 3 * forwards
    return {k_: (n if k_ in POLICY_KERNELS[name] else 0) for k_ in KERNELS}


def cs_profile(torch, make, reqs, what, smi):
    """The device idle share of one drain, the card's activity only,
    after a warm-up drain of the same requests."""
    from torch.profiler import ProfilerActivity, profile
    eng = make()
    eng.warmup()
    cs_serve(eng, reqs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cs_serve(eng, reqs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = sorted(device_records(prof), reverse=True)
    busy = sum(ms for ms, _ in dev)
    log("# continuous profile " + json.dumps({
        "run": what, "card": smi, "wall_ms": wall_ms,
        "device_busy_ms": busy, "device_idle_share": 1 - busy / wall_ms,
        "top_device_ms": [[key[:60], ms] for ms, key in dev[:6]]}))


def cs_run(torch, build, make, reqs, name, what, smi, drained, spec_k=0):
    """One warm engine's drain with its launches counted around it (the
    phase's counts run on) and added into ``drained``; returns (tokens,
    stats)."""
    eng = make()
    eng.warmup()
    torch.cuda.synchronize()
    before = dict(build.LAUNCHES)
    out, wall = cs_serve(eng, reqs)
    torch.cuda.synchronize()
    moved = {k: build.LAUNCHES.get(k, 0) - before.get(k, 0)
             for k in KERNELS}
    st = eng.stats()
    want = cs_expected(name, st, spec_k, CS_REQUESTS if spec_k else 0)
    if moved != want:
        raise AssertionError(f"continuous {what}: launches {moved}, "
                             f"expected {want} (stats {st})")
    for k, v in moved.items():
        drained[k] += v
    if getattr(eng, "paged", False):
        eng.pages.check_invariants()
        if eng.pages.active_pages():
            raise AssertionError(f"continuous {what}: "
                                 f"{eng.pages.active_pages()} pages active "
                                 "after the drain")
    new = sum(len(t) for t in out.values())
    assert all(((t >= 0) & (t < 50257)).all() for t in out.values())
    row = {"run": what, "card": smi, "tok_per_s": new / wall,
           "wall_s": wall, "new_tokens": new,
           "launches": {k: v for k, v in moved.items() if v},
           **{k: st[k] for k in ("mean_ttft_s", "slot_utilization",
                                 "ticks", "prefill_chunks", "prefix_hits",
                                 "prefix_hit_tokens", "cow_copies",
                                 "acceptance_rate", "proposed", "accepted")
              if k in st}}
    log("# continuous " + json.dumps(row))
    return out, st


def cs_static(np, params, cfg, policy, reqs, max_prompt=CS_PROMPT,
              max_seq=CS_MAX_SEQ):
    """Each request served by the static engine, alone but for a
    companion prompt of its bucket's length: the batch is then left-padded
    to the bucket, as the continuous engine's insert pads it, and every
    cut packs per request, so the companion changes nothing of its
    numerics."""
    from repro_torch.serve import cache as C
    from repro_torch.serve.engine import Request, ServeEngine
    buckets = C.prompt_buckets(max_prompt)
    eng = ServeEngine(params, cfg, policy, max_batch=2, max_seq=max_seq)
    out = {}
    for rid, (prompt, new, _) in enumerate(reqs):
        b = C.bucket_for(len(prompt), buckets)
        done = eng.generate([Request(prompt, new),
                             Request(np.zeros(b, np.int64), 1)])
        out[rid] = done[0].out
    return out


def continuous(torch, np, D, build, smi):
    """Phase 11: ``ContinuousEngine`` at full width — slab greedy under
    none / q4q8 / top10, sampled, EOS, paged with prefix sharing and
    chunked prefill, speculative — and ``launch/serve`` in subprocesses.
    Returns the phase's launches."""
    import functools
    import tempfile
    from repro_torch.configs.registry import get
    from repro_torch.core.policy import POLICIES
    from repro_torch.models import transformer
    from repro_torch.serve.engine import ContinuousEngine
    from repro_torch.serve.sampling import SamplingConfig

    cfg = get("gpt2-small")
    params = transformer.init_params(
        torch.Generator(device="cuda").manual_seed(0), cfg)
    reqs = cs_requests(np, cfg.vocab_size)
    preqs = cs_requests(np, cfg.vocab_size, CS_SHARED)

    def engine(name, tick_chunk=8, **kw):
        return ContinuousEngine(params, cfg, POLICIES[name](),
                                num_slots=CS_SLOTS, max_seq=CS_MAX_SEQ,
                                tick_chunk=tick_chunk, **kw)

    slab = {n: functools.partial(engine, n, max_prompt=CS_PROMPT)
            for n in CS_POLICIES}
    paged_kw = dict(max_prompt=CS_PROMPT + CS_SHARED, prefix_cache=True,
                    prefill_chunk=CS_CHUNK, page_size=CS_PAGE)
    paged = {n: functools.partial(engine, n, **paged_kw)
             for n in ("none", "q4q8", "top10")}
    t0 = time.perf_counter()
    build.reset_launches()                  # the phase 11 paths start here
    drained = dict.fromkeys(KERNELS, 0)     # the counted drains' part
    greedy = {}
    for name in CS_POLICIES:                # (a) slab, greedy
        greedy[name], _ = cs_run(torch, build, slab[name], reqs, name,
                                 f"slab/{name}", smi, drained)
    smp = SamplingConfig(**CS_SAMPLING)     # (b) sampled
    sampled = functools.partial(engine, "top10", max_prompt=CS_PROMPT,
                                sampling=smp)
    samp, _ = cs_run(torch, build, sampled, reqs, "top10",
                     f"slab/top10/{smp.name}", smi, drained)
    pout, pst = cs_run(torch, build, paged["top10"], preqs, "top10",
                       "paged/top10", smi, drained)  # (d) paged
    if not pst["prefix_hits"]:
        raise AssertionError(f"paged/top10: no prefix hit ({pst})")
    spec = {}                               # (e) speculative
    draft1 = transformer.init_params(
        torch.Generator(device="cuda").manual_seed(1), cfg)
    for dname, dparams in (("target", params), ("seed-1", draft1)):
        make = functools.partial(engine, "q4q8", draft_params=dparams,
                                 draft_cfg=cfg,
                                 draft_policy=POLICIES["q4q8"](),
                                 spec_k=CS_SPEC_K, **paged_kw)
        spec[dname], _ = cs_run(torch, build, make, preqs, "q4q8",
                                f"speculative/q4q8/draft {dname}", smi,
                                drained, spec_k=CS_SPEC_K)
    torch.cuda.synchronize()
    launches = {k: build.LAUNCHES.get(k, 0) for k in KERNELS}  # read here
    log(f"# phase 11 launches {launches}: drains {drained}, warm-ups "
        f"{ {k: launches[k] - drained[k] for k in KERNELS} } (runs done "
        f"at {time.perf_counter() - t0:.1f} s)")
    for what, make, rq in (("slab/q4q8", slab["q4q8"], reqs),
                           ("paged/top10", paged["top10"], preqs),
                           ("speculative/q4q8/draft target",
                            functools.partial(
                                engine, "q4q8", draft_params=params,
                                draft_cfg=cfg,
                                draft_policy=POLICIES["q4q8"](),
                                spec_k=CS_SPEC_K, **paged_kw), preqs)):
        cs_profile(torch, make, rq, what, smi)
    # the launchers run beside the checks below, which compare tokens only
    with tempfile.TemporaryDirectory() as tmp, reaped([]) as waves:
        waves.append(cs_launchers(params, tmp))
        cs_checks(torch, np, D, smi, t0, cfg, params, reqs, preqs, engine,
                  slab, paged, greedy, samp, sampled, smp, pout, spec)
        log(f"# continuous checks done at {time.perf_counter() - t0:.1f} s")
        cs_launcher_results(waves[0], smi)
    log(f"# continuous launchers done at {time.perf_counter() - t0:.1f} s")
    return launches


def cs_checks(torch, np, D, smi, t0, cfg, params, reqs, preqs, engine,
              slab, paged, greedy, samp, sampled, smp, pout, spec):
    """Phase 11's checks of the counted drains' tokens (see
    ``continuous``)."""
    import functools
    from repro_torch.core.policy import POLICIES

    # (a) each request alone through the static engine, the plain backend
    gapsets = {}
    for name in CS_POLICIES:
        ref, gaps = cs_gap_run(torch, slab[name], reqs)
        gapsets[name] = gaps
        cs_parts(greedy[name], ref, gaps, f"slab/{name} 8-tick chunks vs "
                 "single ticks", smi)
        alone = cs_static(np, params, cfg, POLICIES[name](), reqs)
        cs_parts(alone, ref, gaps, f"slab/{name} vs each request alone "
                 "(static engine)", smi)
    D.KERNEL_BACKEND = "plain"
    try:
        plain = {n: cs_serve(slab[n](), reqs)[0] for n in CS_POLICIES}
        plain_paged = cs_serve(paged["top10"](), preqs)[0]
    finally:
        D.KERNEL_BACKEND = "auto"
    for name in CS_POLICIES:
        cs_exact(plain[name], greedy[name], f"slab/{name} plain backend")
    cs_exact(plain_paged, pout, "paged/top10 plain backend")
    log("# continuous: the plain backend on the card gives identical "
        f"tokens (slab none / q4q8 / top10, paged top10; at "
        f"{time.perf_counter() - t0:.1f} s)")

    # (b) sampled: alone with the same seed, and twice in a row
    again, _ = cs_serve(sampled(), reqs)
    cs_exact(again, samp, "sampled twice in a row")
    solo = sampled()
    for rid, req in enumerate(reqs):
        one, _ = cs_serve(solo, [req])
        (tok,) = one.values()
        cs_exact({rid: tok}, {rid: samp[rid]}, "sampled alone vs batched")
    log(f"# continuous sampled ({smp.name}, top10): each request alone "
        "with its seed, and the batch twice in a row, give identical "
        "tokens")

    # (c) EOS: a request stops at its EOS token; a slot freed while the
    # queue holds requests is refilled on the next tick
    ref = greedy["q4q8"]
    # the first request whose stream holds a token first seen at step 2
    # or later: that token is the EOS, so the request stops mid-stream
    rid, stop = next((r, i) for r in sorted(ref)
                     for i in range(2, len(ref[r]))
                     if ref[r][i] not in ref[r][:i])
    eos = int(ref[rid][stop])
    eng = slab["q4q8"]()
    for prompt, new, seed in reqs:
        eng.submit(prompt, max_new_tokens=new, eos_token=eos, seed=seed)
    out, placed, freed = {}, {}, []
    fills = eng.sched.fills

    def spy(can_place=None):
        got = fills(can_place)
        for slot, r in got:
            placed[r.req_id] = (slot, eng.ticks)
        return got

    eng.sched.fills = spy
    while not eng.sched.idle:
        tick = eng.ticks
        for r in eng.step():
            out[r.req_id] = r.out.copy()
            if len(r.tokens) > 1 and eng.sched.queue:
                freed.append((r.req_id, r.slot, tick))
    truncated = {}
    for r, toks in ref.items():
        hit = np.nonzero(toks == eos)[0]
        truncated[r] = toks[:hit[0] + 1] if len(hit) else toks
    if len(out[rid]) != stop + 1 or out[rid][-1] != eos:
        raise AssertionError(f"EOS {eos}: request {rid} gave {out[rid]}, "
                             f"greedy {ref[rid]}")
    cs_parts(out, truncated, gapsets["q4q8"], f"slab/q4q8 EOS {eos} vs "
             "the greedy streams cut at it", smi)
    late = [(r, s, t) for r, s, t in freed
            if (s, t + 1) not in placed.values()]
    if late or not freed or eng.stats()["completed"] != CS_REQUESTS:
        raise AssertionError(f"EOS: slots freed {freed} and not refilled "
                             f"on the next tick: {late} (placed {placed})")
    log("# continuous EOS " + json.dumps({
        "card": smi, "eos": eos, "request": rid, "stopped_after": stop + 1,
        "freed_and_refilled_next_tick": len(freed)}))

    # (d) paged against its single-tick twin, against the slab under
    # none, and (e) speculative against paged greedy
    ref, gaps = cs_gap_run(torch, paged["top10"], preqs)
    cs_parts(pout, ref, gaps, "paged/top10 vs its gap run", smi)
    pnone, gnone = cs_gap_run(torch, paged["none"], preqs)
    snone = cs_serve(functools.partial(
        engine, "none", max_prompt=CS_PROMPT + CS_SHARED)(), preqs)[0]
    cs_parts(snone, pnone, gnone, "slab/none vs paged/none (shared "
             "prefix)", smi)
    ref, gaps = cs_gap_run(torch, paged["q4q8"], preqs)
    for dname, out in spec.items():
        cs_parts(out, ref, gaps, f"speculative/q4q8 draft {dname} vs "
                 "paged greedy", smi)
    # the slab's prefill packs a request's whole padded prompt as one
    # payload, the paged chunks pack each token alone: under TopK the two
    # differ by design (the reference's own speculative test compares
    # paged runs only), so this is counted, not held
    s10 = cs_serve(functools.partial(
        engine, "top10", max_prompt=CS_PROMPT + CS_SHARED)(), preqs)[0]
    log("# continuous slab/top10 vs paged/top10 (not held: payload "
        "granularity) " + json.dumps({
            "card": smi, "identical_streams": sum(
                np_equal(s10[r], pout[r]) for r in pout),
            "identical_first_tokens": sum(
                int(s10[r][0]) == int(pout[r][0]) for r in pout),
            "streams": len(pout)}))

    # the cache's last row: warm-up serves the largest bucket with the one
    # token that fits, then decodes with every slot idle; a slab request
    # fills the cache beside a longer one; a paged prompt's padded last
    # chunk reaches past the slot's last page
    rng = np.random.RandomState(1)
    full = functools.partial(engine, "q4q8", max_prompt=CS_MAX_SEQ)
    freqs = [(rng.randint(0, 1024, 100).astype(np.int64), 129, 0),
             (rng.randint(0, 1024, 10).astype(np.int64), 160, 1)]
    warm = full()
    warm.warmup()
    ref, gaps = cs_gap_run(torch, full, freqs)
    cs_parts(cs_serve(warm, freqs)[0], ref, gaps, "slab/q4q8 a request "
             "filling the cache, 8-tick chunks after warm-up vs single "
             "ticks", smi)
    pfull = [(rng.randint(0, 1024, 250).astype(np.int64), 6, 0),
             (rng.randint(0, 1024, 10).astype(np.int64), 20, 1)]
    chunked = functools.partial(engine, "top10", max_prompt=CS_MAX_SEQ,
                                page_size=CS_PAGE)
    ref, gaps = cs_gap_run(torch, functools.partial(
        chunked, prefill_chunk=CS_CHUNK), pfull)
    cs_parts(cs_serve(chunked(prefill_chunk=24), pfull)[0], ref, gaps,
             "paged/top10 24-token chunks past the last page vs 16-token "
             "chunks", smi)


CS_LAUNCHERS = {"sampled": ["--temperature", "0.8", "--top-k", "40"],
                "paged": ["--prefix-cache", "--prefill-chunk", "16",
                          "--shared-prefix", "48"],
                "speculative": ["--draft", "gpt2-small", "--spec-k", "4"],
                "ckpt": ["--ckpt"]}


def cs_launchers(params, tmp):
    """``launch/serve --engine continuous`` in subprocesses, all started
    at once: sampled, paged with a shared prefix, speculative, and from a
    params file (``--ckpt``, saved under ``tmp``).  Returns the
    processes (:func:`cs_launcher_results` reads them)."""
    from repro_torch.checkpoint import io as ckpt_io
    base = ["repro_torch.launch.serve", "--engine", "continuous",
            "--policy", "top10", "--requests", "8", "--prompt-len", "32",
            "--new-tokens", "8"]
    path = os.path.join(tmp, "params.npz")
    ckpt_io.save(path, params, step=7)
    return launchers({k: base + v + ([path] if k == "ckpt" else [])
                      for k, v in CS_LAUNCHERS.items()})


def cs_launcher_results(procs, smi):
    """Each launcher of :func:`cs_launchers` must exit 0 and serve every
    request; they share the card, so their rates are not logged."""
    res = launcher_results(procs)
    for k, (rc, recs, out) in res.items():
        if rc != 0 or len(recs) != 1 or recs[0]["completed"] != 8 or (
                k == "ckpt" and "restored step-7 params" not in out):
            raise AssertionError(f"launch/serve {' '.join(CS_LAUNCHERS[k])} "
                                 f"exited {rc}: {out[-4000:]}")
        log("# launch/serve --engine continuous " + json.dumps({
            "run": k, "card": smi, "exit": rc, **{
                x: recs[0][x] for x in (
                    "completed", "slot_utilization", "prefix_hits",
                    "acceptance_rate") if x in recs[0]}}))


# ---------------------------------------------------------------------------
# phase 12: telemetry (trace, export, quality tap, probe-driven flip)
# ---------------------------------------------------------------------------

# (a) the simulated cuts with the quality tap, (b) pipeline x DP, (c) the
# tensor axis, through launch/train; (d) paged serving through
# launch/serve; (e) run_lm_experiment's probe-driven flip.  Full width,
# seed-0 weights.
TEL_TRAIN = ["--feedback", "aqsgd", "--k-frac", "0.1", "--steps", "4",
             "--batch", "8", "--seq", "128", "--log-every", "1"]
TEL_METRICS = 2                # tap samples at steps 2 and 4
TEL_PD = ["--mesh", "data=2,stage=4", "--wire", "data=q8", "--policy",
          "q4q8", "--steps", "2", "--batch", "32", "--seq", "128",
          "--pipeline-microbatches", "4", "--log-every", "1"]
TEL_TP = ["--mesh", "tensor=2", "--wire", "tensor=q8", "--steps", "2",
          "--batch", "8", "--seq", "128", "--log-every", "1"]
TEL_SERVE = ["--policy", "top10", "--prefix-cache", "--prefill-chunk", "16",
             "--shared-prefix", "48", "--metrics", "2"]
TEL_FLIP_RULES = "q8@bandwidth>=1e9;q4"
# 2 steps of 8 x 128 an epoch, 1 test batch
TEL_FLIP_DATA = dict(num_train=16, num_test=8, seq_len=128, seed=0)
TEL_FLIP_BATCH = 8
TEL_LOW_BW = 1e6               # the scripted epoch-1 reading, bytes/s


def run_main(main, argv):
    """A launcher's ``main(argv)`` in this process: its exit code and its
    stdout (the trace lines are logged)."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    out = buf.getvalue()
    for ln in out.splitlines():
        if ln.startswith(("# trace:", "# perfetto:")):
            log(ln)
    if rc != 0:
        raise AssertionError(f"{argv} exited {rc}: {out[-2000:]}")
    return out


def read_trace(jsonl, chrome=None):
    """A trace file's events after its schema check; the Chrome file, when
    given, must load with as many ``traceEvents``."""
    from repro_torch.obs.export import validate_jsonl
    n = validate_jsonl(jsonl)
    with open(jsonl) as f:
        ev = [json.loads(ln) for ln in f if ln.strip()]
    assert len(ev) == n, (jsonl, n, len(ev))
    if chrome is not None:
        with open(chrome) as f:
            doc = json.load(f)
        if len(doc["traceEvents"]) != n:
            raise AssertionError(f"{chrome}: {len(doc['traceEvents'])} "
                                 f"events, the JSONL {n}")
    return ev


def codec_kernels(policy):
    """Kernel launches of one C(x) pass over every boundary's fw and bw
    compressors (what a quality-tap sample, or a simulated step's cuts,
    launch)."""
    n = dict.fromkeys(KERNELS, 0)
    for i in range(policy.num_boundaries):
        for comp in (policy.at(i).fw, policy.at(i).bw):
            if comp.kind == "quant":
                n["quant_dequant"] += 1
            elif comp.kind == "topk":
                n["topk_block"] += 1
    return n


def launch_delta(build, before):
    return {k: build.LAUNCHES.get(k, 0) - before.get(k, 0) for k in KERNELS}


def tel_train(torch, build, smi, tmp, base, card):
    """(a) ``launch/train`` AQ-SGD with and without ``--trace --perfetto
    --metrics``: the events, exact launches (the run's plus the tap's),
    the same losses bitwise, and the wall time of steps 2-4 of each."""
    from repro_torch.launch import train as lt
    real = lt.make_lm_train_step
    rec = {}

    def timed(*a, **k):
        step = real(*a, **k)

        def run(*args):
            t0 = time.perf_counter()
            out = step(*args)
            loss = out[-1]["loss"].item()          # waits for the device
            rec.setdefault("steps", []).append(
                (t0, time.perf_counter(), loss))
            return out
        return run

    policy = lt.build_policy("none", "aqsgd", 0.1)
    per = codec_kernels(policy)
    steps = int(TEL_TRAIN[TEL_TRAIN.index("--steps") + 1])
    samples = steps // TEL_METRICS
    jsonl, chrome = os.path.join(tmp, "a.jsonl"), os.path.join(tmp, "a.json")
    flags = ["--trace", jsonl, "--perfetto", chrome, "--metrics",
             str(TEL_METRICS)]
    runs = {}
    lt.make_lm_train_step = timed
    try:
        for name, extra in (("plain", []), ("traced", flags),
                            ("plain again", [])):
            rec.clear()
            before = dict(build.LAUNCHES)
            out = run_main(lt.main, base + TEL_TRAIN + extra)
            runs[name] = {"launches": launch_delta(build, before),
                          "losses": [s[2] for s in rec["steps"]],
                          "lines": _loss_lines([json.loads(ln) for ln in
                                                out.splitlines()
                                                if ln.startswith("{")]),
                          "steps_2_4_s": rec["steps"][-1][1]
                          - rec["steps"][1][0]}
    finally:
        lt.make_lm_train_step = real
    for name in ("traced", "plain again"):
        if (runs[name]["losses"] != runs["plain"]["losses"]
                or runs[name]["lines"] != runs["plain"]["lines"]):
            raise AssertionError(f"(a) {name}: losses {runs[name]['losses']}"
                                 f" != {runs['plain']['losses']}")
    want = {k: steps * v for k, v in per.items()}
    tap = {k: samples * v for k, v in per.items()}
    if card:
        for name in ("plain", "plain again"):
            assert runs[name]["launches"] == want, (name, runs[name], want)
        got = runs["traced"]["launches"]
        if got != {k: want[k] + tap[k] for k in KERNELS}:
            raise AssertionError(f"(a) traced launches {got}, want the "
                                 f"run's {want} + the tap's {tap}")
    ev = read_trace(jsonl, chrome)
    keys = [f"[{i}]['fw'].resid" for i in range(policy.num_boundaries)]
    quality = [n for b in range(policy.num_boundaries)
               for n in (f"quality.boundary{b}", f"quality.codec.boundary{b}")
               ] + ["quality.feedback_norms"]
    names = []
    for s in range(1, steps + 1):
        names.append("train.step")
        if s % TEL_METRICS == 0:
            names += quality
    if [e["name"] for e in ev] != names:
        raise AssertionError(f"(a) events {[e['name'] for e in ev]}")
    for e in ev:
        if e["name"] == "train.step":
            assert e["ph"] == "X" and e["args"]["loss"] == round(
                runs["traced"]["losses"][e["args"]["step"] - 1], 6), e
        elif e["name"] == "quality.feedback_norms":
            assert list(e["args"]) == keys, e
            assert all(v > 0 and math.isfinite(v)
                       for v in e["args"].values()), e
        elif e["name"].startswith("quality.codec"):
            assert e["args"]["step"] % TEL_METRICS == 0, e
            assert (e["args"]["fw_codec"], e["args"]["bw_codec"]) == (
                policy.at(0).fw.name, policy.at(0).bw.name), e
        else:
            assert all(0 < v < 1 for v in e["args"].values()), e
    log("# telemetry (a) " + json.dumps({
        "card": smi, "events": len(ev),
        "launches": {n: {k: v for k, v in r["launches"].items() if v}
                     for n, r in runs.items()},
        "tap_launches": {k: v for k, v in tap.items() if v},
        "losses": runs["traced"]["losses"],
        "norms_step_4": ev[-1]["args"],
        "rel_err_step_4": [e["args"] for e in ev
                           if e["name"].startswith("quality.boundary")][-3:],
        "steps_2_4_s": {n: r["steps_2_4_s"] for n, r in runs.items()}}))


def tel_wire(torch, smi, tmp, base, dev, cfg):
    """(b) pipeline x DP and (c) the tensor axis through ``launch/train
    --trace``: each wire event as many times as the reference (twice in 2
    steps: the step's first key, then its own outputs') with the args of
    ``wire_telemetry`` / ``dp_wire_report`` / ``tp_wire_report``."""
    from repro_torch.core.policy import POLICIES
    from repro_torch.launch import train as lt
    from repro_torch.models import transformer
    from repro_torch.train.steps import _uniform_boundary
    from repro_torch.transport.codecs import LeafStruct, payload_leaves
    from repro_torch.transport.collectives import dp_wire_report
    from repro_torch.transport.pipeline import (PipelineTransport,
                                                wire_telemetry)
    from repro_torch.transport.schedules import get_schedule
    from repro_torch.transport.tp_collectives import TPCollectives

    def opt(argv, flag):
        return argv[argv.index(flag) + 1]

    for name, argv in (("pipeline x DP", TEL_PD), ("tensor", TEL_TP)):
        path = os.path.join(tmp, f"{name[:2]}.jsonl")
        run_main(lt.main, base + argv + ["--trace", path])
        ev = read_trace(path)
        steps = int(opt(argv, "--steps"))
        batch, seq = int(opt(argv, "--batch")), int(opt(argv, "--seq"))
        axes = dict(kv.split("=") for kv in opt(argv, "--mesh").split(","))
        if name == "tensor":
            tp = int(axes["tensor"])
            want = {"tp.wire": {
                "axis": "tensor", "feedback": "none", "fused": True,
                "launches_per_hop": 1,
                **TPCollectives(tp, codec="q8").wire_report(
                    (batch, seq, cfg.d_model),
                    sites=transformer.tp_sites(cfg),
                    dtype=transformer.DTYPE)}}
        else:
            dp, stages = int(axes["data"]), int(axes["stage"])
            mb = int(opt(argv, "--pipeline-microbatches"))
            bp = _uniform_boundary(POLICIES[opt(argv, "--policy")]())
            sched = get_schedule("gpipe", 1)
            params = transformer.init_params(
                torch.Generator(device=dev).manual_seed(0), cfg)
            g_like = [LeafStruct(tuple(a.shape), a.dtype) for a in
                      payload_leaves(transformer.stack_layer_stages(
                          params, stages))]
            rep = dp_wire_report(g_like, "q8", k_frac=0.1, dp=dp)
            want = {
                "pipeline.wire": wire_telemetry(
                    PipelineTransport(bp, stages, fused=sched.fused_wire),
                    sched, (batch // (dp * mb), seq, cfg.d_model),
                    microbatches=mb, dp=dp),
                "dp.wire": {"axis": "data", "feedback": "none",
                            "fused": True, "shard_axis": "stage",
                            "launches_per_hop": 1, **rep}}
            del params
        wire = [e for e in ev if e["cat"] == "wire"]
        # the reference's count: a first key, then the step's own outputs
        count = min(steps, 2)
        got_names = [e["name"] for e in wire]
        if sorted(got_names) != sorted(list(want) * count):
            raise AssertionError(f"({name}) wire events {got_names}")
        for e in wire:
            if e["args"] != want[e["name"]]:
                raise AssertionError(f"({name}) {e['name']} {e['args']} != "
                                     f"{want[e['name']]}")
        assert sum(e["name"] == "train.step" for e in ev) == steps, ev
        log(f"# telemetry ({'b' if name != 'tensor' else 'c'}) " + json.dumps(
            {"run": name, "card": smi, "events": len(ev),
             "wire_events": got_names, **want}))


def tel_serve(smi, tmp, base):
    """(d) ``launch/serve`` paged top10 with ``--trace --perfetto
    --metrics 2``: a ``request_done`` per request, ``serve.sched`` /
    ``serve.pages`` on the ticks of the ``metrics_every`` grid, and the
    mean ``serve.prefill`` / ``serve.decode`` span of the served requests
    (the TTFT split)."""
    from repro_torch.launch import serve as ls
    from repro_torch.obs import trace
    from repro_torch.serve.engine import ContinuousEngine
    every = int(TEL_SERVE[TEL_SERVE.index("--metrics") + 1])
    jsonl, chrome = os.path.join(tmp, "d.jsonl"), os.path.join(tmp, "d.json")
    seen = {"on_grid": 0, "warm_events": None}
    step, warmup = ContinuousEngine.step, ContinuousEngine.warmup

    def counted_step(self):
        out = step(self)
        seen["on_grid"] += self.ticks % self.metrics_every == 0
        return out

    def marked_warmup(self):
        out = warmup(self)
        seen["warm_events"] = len(trace.get_tracer().snapshot())
        return out

    ContinuousEngine.step, ContinuousEngine.warmup = (counted_step,
                                                      marked_warmup)
    try:
        out = run_main(ls.main, base + TEL_SERVE + ["--trace", jsonl,
                                                    "--perfetto", chrome])
    finally:
        ContinuousEngine.step, ContinuousEngine.warmup = step, warmup
    rec = json.loads([ln for ln in out.splitlines()
                      if ln.startswith("{")][0])
    ev = read_trace(jsonl, chrome)
    served = ev[seen["warm_events"]:]
    count = {n: sum(e["name"] == n for e in ev)
             for n in ("serve.request_done", "serve.sched", "serve.pages",
                       "serve.prefill", "serve.decode")}
    done = sum(e["name"] == "serve.request_done" for e in served)
    if done != rec["requests"] or rec["completed"] != rec["requests"]:
        raise AssertionError(f"(d) {done} request_done after the warm-up "
                             f"for {rec['requests']} requests")
    if not count["serve.sched"] == count["serve.pages"] == seen["on_grid"]:
        raise AssertionError(f"(d) counters {count} for {seen['on_grid']} "
                             f"ticks on the every-{every} grid")
    if not (count["serve.prefill"] and count["serve.decode"]):
        raise AssertionError(f"(d) spans {count}")
    pages = [e["args"] for e in served if e["name"] == "serve.pages"]
    if not pages[-1]["prefix_hits"]:
        raise AssertionError(f"(d) no prefix hit: {pages[-1]}")
    split = {}
    for n in ("serve.prefill", "serve.decode"):
        ms = [e["dur_us"] / 1e3 for e in served if e["name"] == n]
        split[n] = {"spans": len(ms), "mean_ms": sum(ms) / len(ms),
                    "total_ms": sum(ms)}
    log("# telemetry (d) " + json.dumps({
        "card": smi, "events": len(ev), "counts": count,
        "ticks_on_grid": seen["on_grid"], "served_split": split,
        "mean_ttft_s": rec["mean_ttft_s"], "tok_per_s": rec["tok_per_s"],
        "last_pages": pages[-1]}))


def tel_flip(torch, build, smi, dev, card, cfg):
    """(e) ``run_lm_experiment`` for 2 epochs under ``q8@bandwidth>=1e9;
    q4``: the real ``probe_mesh({"data": 4})`` reading before epoch 0 (the
    card's one-hop copy rate, far above 1e9 bytes/s), a scripted 1e6
    before epoch 1.  One ``policy.flip``, the policy curve [q8, q4], exact
    launches per epoch (the test batch's compressed eval on top of epoch
    1's)."""
    from repro_torch.core.policy import parse_policy_rules, resolve_policy
    from repro_torch.data.synthetic import LMData
    from repro_torch.obs import trace
    from repro_torch.obs.probes import probe_mesh
    from repro_torch.train.loop import run_lm_experiment
    data = LMData(**TEL_FLIP_DATA)
    rules = parse_policy_rules(TEL_FLIP_RULES)
    marks, readings = [], []

    def probe():
        marks.append(dict(build.LAUNCHES))
        r = (probe_mesh({"data": 4}, device=dev) if not readings
             else TEL_LOW_BW)
        readings.append(r)
        return r

    tr = trace.enable()
    try:
        res = run_lm_experiment(cfg, rules, epochs=2, batch=TEL_FLIP_BATCH,
                                data=data, bandwidth_probe=probe,
                                device=dev)
        ev = [e.to_dict() for e in tr.drain()]
    finally:
        trace.disable()
    end = dict(build.LAUNCHES)
    bsize = data.seq_len * cfg.d_model
    hop = readings[0]["data"]
    pols = [resolve_policy(rules, bsize, bandwidth=hop.bytes_per_s),
            resolve_policy(rules, bsize, bandwidth=TEL_LOW_BW)]
    if res.policy_curve != [p.name for p in pols] or pols[0] == pols[1]:
        raise AssertionError(f"(e) policy curve {res.policy_curve}")
    flips = [e["args"] for e in ev if e["name"] == "policy.flip"]
    if flips != [{"epoch": 1, "bandwidth": TEL_LOW_BW,
                  "old": pols[0].name, "new": pols[1].name}]:
        raise AssertionError(f"(e) flips {flips}")
    steps = data.num_train // TEL_FLIP_BATCH
    test_batches = data.num_test // TEL_FLIP_BATCH
    got = [{k: marks[1].get(k, 0) - marks[0].get(k, 0) for k in KERNELS},
           {k: end.get(k, 0) - marks[1].get(k, 0) for k in KERNELS}]
    want = [{k: steps * v for k, v in codec_kernels(pols[0]).items()}]
    evals = {k: 0 for k in KERNELS}
    for i in range(pols[1].num_boundaries):        # compressed eval: fw
        evals["quant_dequant" if pols[1].at(i).fw.kind == "quant"
              else "topk_block"] += test_batches
    want.append({k: steps * v + evals[k]
                 for k, v in codec_kernels(pols[1]).items()})
    if card and got != want:
        raise AssertionError(f"(e) launches per epoch {got}, want {want}")
    assert sum(e["name"] == "train.step" for e in ev) == 2 * steps, ev
    log("# telemetry (e) " + json.dumps({
        "card": smi, "policy_curve": res.policy_curve, "flip": flips[0],
        "launches_per_epoch": [{k: v for k, v in g.items() if v}
                               for g in got],
        "losses": res.train_curve, "loss_on": res.loss_on,
        "loss_off": res.loss_off,
        "probe": {a: m.to_dict() for a, m in readings[0].items()}}))
    log("# telemetry probe: the card's one-hop copy rate as one of 4 lanes "
        f"sees it, {hop.bytes_per_s:.6g} bytes/s ({hop.payload_bytes} bytes "
        f"a lane in {hop.seconds:.6g} s, best of 3; {smi})")


def telemetry(torch, D, build, smi, dev="cuda", base=()):
    """Phase 12: telemetry through both launchers, the engine and the
    probe-driven flip, launch counters set to 0 just before and read just
    after.  ``dev`` / ``base`` let a rehearsal run it on the CPU at smoke
    size (``base``: the launchers' extra flags).  Returns the phase's
    launches."""
    import tempfile
    from repro_torch.configs.registry import get
    base = list(base)
    card = dev == "cuda"
    cfg = get("gpt2-small", smoke="--smoke" in base)
    t0 = time.perf_counter()
    build.reset_launches()                  # the phase 12 paths start here
    with tempfile.TemporaryDirectory() as tmp:
        tel_train(torch, build, smi, tmp, base, card)
        tel_wire(torch, smi, tmp, base, dev, cfg)
        tel_serve(smi, tmp, base)
    tel_flip(torch, build, smi, dev, card, cfg)
    if card:
        torch.cuda.synchronize()
    launches = {k: build.LAUNCHES.get(k, 0) for k in KERNELS}  # read here
    log(f"# phase 12 launches {launches} ({time.perf_counter() - t0:.1f} s)")
    return launches


# ---------------------------------------------------------------------------
# phase 13: gemma2-27b and pixtral-12b at full width (the attention
# variants, post-norm and the vision frontend)
# ---------------------------------------------------------------------------

# the registry configs at full width, depth cut with dataclasses.replace:
# gemma2 4 layers (2 local/global groups; the launcher's 4-stage presets
# stop at the 2 groups: 1 cut), pixtral 4 layers (4 stages: 3 cuts)
BIG_LAYERS, BIG_STEPS = 4, 3
# arch -> (batch, seq, policies trained, the training-cut launches of a
# step under a compressing policy: forward and backward at each cut)
BIG_TRAIN = {"gemma2-27b": (1, 8192, ("none", "q4q8", "top10"), 2),
             "pixtral-12b": (2, 1024, ("q4q8", "top10"), 6)}
# static serving: gemma2's 4,100-token prompt plus 16 new tokens wraps the
# local layers' 4,096-row ring; the slab engine's 2 slots, 8,192-row
# global caches and a 4,100-token bucket; pixtral's equal-length prompts
G2_PROMPTS, BIG_NEW = (4100, 300), 16
G2_CS_PROMPTS, G2_CS_MAX_SEQ, G2_CS_SLOTS = (4100, 300, 1000), 8192, 2
PX_PROMPTS = (512, 512)
BIG_SERVE = ("none", "q4q8")
TRAIN_CUT_KERNELS = {"none": None, "q4q8": "quant_dequant",
                     "top10": "topk_block"}
# phase 2 at phase 13's cut shapes: the (B, S * d) bf16 tensor of a cut
BIG_CUTS = {"gemma2 cut (1, 8192*4608) bf16": (1, 8192 * 4608),
            "pixtral cut (2, 1024*5120) bf16": (2, 1024 * 5120)}
# ... and at its q4q8 serving wire's rows, one (min, scale) a row: the
# static prefills (left-padded to the longest prompt), a slab insert at
# its bucket, the decode ticks; the rows timed are marked True
BIG_Q4 = {"gemma2 static prefill (2, 4100*4608) f32": ((2, 4100 * 4608), True),
          "gemma2 slab insert (1, 1024*4608) f32": ((1, 1024 * 4608), False),
          "gemma2 decode (2, 4608) f32": ((2, 4608), False),
          "pixtral static prefill (2, 512*5120) f32": ((2, 512 * 5120), True),
          "pixtral decode (2, 5120) f32": ((2, 5120), False)}


def big_kernels(torch, D, ops, pack4, cut_shapes=None, q4_rows=None):
    """Phase 2 at phase 13's shapes (or phase 14's: ``cut_shapes``,
    ``q4_rows``): ``quant_dequant`` (bits 4, 8) and ``topk_block`` (k 0.1,
    0.3) at the training cuts, and the q4 pair at the serving wire's rows
    with per-row statistics (the codec's ``per_request=True``), bit-exact
    against their plain versions; then the cuts and the long rows timed
    with their bounds."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    cuts = {label: torch.randn(shape, generator=gen, device="cuda")
            .to(torch.bfloat16)
            for label, shape in (cut_shapes or BIG_CUTS).items()}
    err = check_cut_kernels(torch, D, ops, cuts)
    timed = {}
    for label, x in cuts.items():
        timed[label] = time_cut_kernels(torch, D, ops, x)
        for name, row in timed[label].items():
            log(f"# {name} {label}: " + json.dumps(row))
    del cuts
    for label, (shape, timed_too) in (q4_rows or BIG_Q4).items():
        # the wire casts the bf16 cut tensor to f32
        x = torch.randn(shape, generator=gen, device="cuda") \
            .to(torch.bfloat16).float()
        got = check_q4(torch, D, pack4, x, *pack4.minmax_scale(x))
        for name, e in zip(("pack4_wire", "unpack4_wire"), got):
            err[name] = max(err.get(name, 0.0), e)
        log(f"# q4 kernels bit-exact vs plain: {label}")
        if timed_too:
            timed[label] = time_pack4(torch, D, pack4, x)
            for name, row in timed[label].items():
                log(f"# {name} {label}: " + json.dumps(row))
    return {k: err.get(k, 0.0) for k in KERNELS}, timed


def _free(torch):
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def big_train_run(torch, build, cfg, arch, name, smi, profile_step=None,
                  steps=BIG_STEPS, dp=1, grad_accum=1, policy_name=None,
                  enc_embeds=None):
    """``steps`` steps of ``cfg`` (``arch`` of ``BIG_TRAIN``,
    ``MOE_TRAIN``, ``REC_TRAIN`` or ``WH_TRAIN``) under ``policy_name``
    (``name``, the run's label, by default) as ``launch/train`` builds
    them (its AdamW, ``make_batch``, the synthetic stream), the params and
    moments donated (updated in place, the same bits), from seed-0
    weights drawn on the card; ``dp`` DP lanes on the q8 reduce,
    ``grad_accum`` pieces, and the encoder-decoder's frame embeddings a
    step from ``enc_embeds``.  Launches exact, losses finite (and falling
    over 3 steps or more).  Prints and returns the run."""
    from repro_torch.core.boundary import init_boundary_state
    from repro_torch.core.parallel import AxisSpec, ParallelSpec
    from repro_torch.launch.train import (build_policy, make_batch,
                                          synthetic_stream)
    from repro_torch.models import encdec, transformer
    from repro_torch.optim.optimizers import OptimizerConfig, init_opt_state
    from repro_torch.train.loop import init_lm_dp_state
    from repro_torch.train.steps import make_lm_train_step

    batch, seq, _, per_step = {**BIG_TRAIN, **MOE_TRAIN, **REC_TRAIN,
                               **WH_TRAIN}[arch]
    pname = policy_name or name
    policy = build_policy(pname, "none")
    opt = OptimizerConfig(kind="adamw", lr=1e-3, weight_decay=0.01,
                          schedule="cosine", t_max=steps, grad_clip=1.0)
    mod = encdec if cfg.enc_dec else transformer
    cuts = len(transformer.segment_bounds(
        cfg.num_layers if cfg.enc_dec else cfg.num_groups,
        policy.num_stages)) - 1
    bstates = [init_boundary_state(policy.at(i), (seq, cfg.d_model),
                                   batch=batch, dtype=torch.bfloat16,
                                   device="cuda") for i in range(cuts)]
    torch.cuda.reset_peak_memory_stats()
    params = mod.init_params(
        torch.Generator(device="cuda").manual_seed(0), cfg)
    opt_state = init_opt_state(opt, params)
    extra, kw = (), {}
    if dp > 1:
        kw["parallel"] = ParallelSpec({"data": AxisSpec(size=dp,
                                                        codec="q8")})
        extra = (init_lm_dp_state(cfg, params, policy, dp, "none"),)
    step = make_lm_train_step(cfg, policy, opt, donate=True,
                              grad_accum=grad_accum, **kw)
    stream = synthetic_stream(cfg, batch, seq, 0)
    kernel = TRAIN_CUT_KERNELS[pname]
    want = {k: per_step * dp * grad_accum if k == kernel else 0
            for k in KERNELS}
    if dp > 1:
        want.update(frame_parts=dp, decode_sum_fused=1)
    losses, auxes, seconds, peaks, prof = [], [], [], [], None
    for i in range(1, steps + 1):
        toks, ids = next(stream)
        b = make_batch(cfg, toks, "cuda")
        if enc_embeds is not None:
            b["enc_embeds"] = enc_embeds[i - 1]
        ids = torch.from_numpy(ids).to("cuda")
        before = dict(build.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == profile_step:
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                out = step(params, opt_state, bstates, b, ids, *extra)
                torch.cuda.synchronize()
        else:
            out = step(params, opt_state, bstates, b, ids, *extra)
            torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        params, opt_state, bstates, m = out[0], out[1], out[2], out[-1]
        extra = out[3:-1]
        losses.append(float(m["loss"]))
        auxes.append(float(m["aux"]))
        peaks.append(torch.cuda.max_memory_allocated())
        got = {k: build.LAUNCHES.get(k, 0) - before.get(k, 0)
               for k in KERNELS}
        if got != want:
            raise AssertionError(f"{cfg.arch_id} {name} step {i}: launches "
                                 f"{got}, expected {want}")
    peak = torch.cuda.max_memory_allocated()
    del params, opt_state, step, bstates, extra, out
    _free(torch)
    if not (all(math.isfinite(v) for v in losses)
            and (steps < 3 or losses[-1] < losses[0])):
        raise AssertionError(f"{cfg.arch_id} {name}: losses {losses} are "
                             "not finite and falling")
    if cfg.num_experts and not all(math.isfinite(v) and v > 0
                                   for v in auxes):
        raise AssertionError(f"{cfg.arch_id} {name}: MoE aux {auxes}")
    row = {"arch": cfg.arch_id, "policy": name, "card": smi,
           "batch": batch, "seq": seq, "cuts": cuts, "losses": losses,
           "aux": auxes,
           "launches_per_step": {k: v for k, v in want.items() if v},
           "step_s": seconds,
           "tokens_per_s": [batch * seq / t for t in seconds],
           "tokens_per_s_steps_2_to_3": batch * seq * (steps - 1)
           / sum(seconds[1:]), "max_memory_allocated_by_step": peaks,
           "max_memory_allocated": peak}
    if cfg.enc_dec:
        row.update(enc_seq=cfg.enc_seq, dp=dp, grad_accum=grad_accum)
    if prof is not None:
        dev = sorted(device_records(prof), reverse=True)
        busy = sum(ms for ms, _ in dev)
        wall = seconds[profile_step - 1] * 1e3
        row.update(profiled_step=profile_step, profiled_wall_ms=wall,
                   device_busy_ms=busy, device_idle_share=1 - busy / wall,
                   unprofiled_step_ms=1e3 * seconds[1],
                   top_device_ms=[[key[:60], ms] for ms, key in dev[:6]])
    log("# big train " + json.dumps(row))
    return row


def big_static(torch, np, build, params, cfg, name, prompts, smi):
    """``ServeEngine`` on ``prompts`` (left-padded to the longest), 16 new
    tokens each: tokens, launches exact (each cut packs once a forward),
    wall time."""
    from repro_torch.core.policy import POLICIES
    from repro_torch.models import transformer
    from repro_torch.serve.engine import Request, ServeEngine
    policy = POLICIES[name]()
    eng = ServeEngine(params, cfg, policy, max_batch=len(prompts),
                      max_seq=max(len(p) for p in prompts) + BIG_NEW - 1)
    before = dict(build.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.generate([Request(p, BIG_NEW) for p in prompts])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    toks = np.stack([r.out for r in out])
    assert toks.shape == (len(prompts), BIG_NEW)
    assert ((toks >= 0) & (toks < cfg.vocab_size)).all()
    cuts = len(transformer.segment_bounds(cfg.num_groups,
                                          policy.num_stages)) - 1
    moved = {k: build.LAUNCHES.get(k, 0) - before.get(k, 0) for k in KERNELS}
    want = {k: (BIG_NEW * cuts if k in POLICY_KERNELS[name] else 0)
            for k in KERNELS}
    if moved != want:
        raise AssertionError(f"{cfg.arch_id} static {name}: launches "
                             f"{moved}, expected {want}")
    log("# big serve " + json.dumps({
        "arch": cfg.arch_id, "engine": "static", "policy": name,
        "card": smi, "prompts": [len(p) for p in prompts],
        "new_tokens": BIG_NEW, "cuts": cuts, "wall_s": wall,
        "tok_per_s": len(prompts) * BIG_NEW / wall,
        "launches": {k: v for k, v in moved.items() if v},
        "tokens[0][:8]": toks[0, :8].tolist()}))
    return toks


def big_continuous(torch, np, build, params, cfg, smi, names=BIG_SERVE):
    """A windowed arch (gemma2, mixtral) through the slab
    ``ContinuousEngine`` under each policy of ``names``: the ring leaves'
    rows, the drains' launches, each stream against the single-tick run
    (near-tie rule) and against each request served alone by the static
    engine; the prefix cache refused with the reference's message."""
    import functools
    from repro_torch.core.policy import POLICIES
    from repro_torch.models import transformer
    from repro_torch.models.blocks import _attn_kwargs
    from repro_torch.serve.engine import ContinuousEngine
    arch = cfg.arch_id.split("-")[0]
    rng = np.random.RandomState(5)
    reqs = [(rng.randint(0, cfg.vocab_size, n).astype(np.int64), BIG_NEW, i)
            for i, n in enumerate(G2_CS_PROMPTS)]
    kw = dict(num_slots=G2_CS_SLOTS, max_seq=G2_CS_MAX_SEQ,
              max_prompt=max(G2_CS_PROMPTS))
    try:
        ContinuousEngine(params, cfg, POLICIES["q4q8"](), prefix_cache=True,
                         **kw)
    except ValueError as e:
        if "sliding-window ring buffers are unsupported" not in str(e):
            raise
        log(f"# big continuous: prefix_cache=True refused: {e}")
    else:
        raise AssertionError(f"{arch}: prefix_cache=True was not refused")
    # a ring of min(window, max_seq) rows where the kind has a window
    want_rows = {}
    for i, kind in enumerate(cfg.layer_kinds()):
        w = _attn_kwargs(cfg, kind)["window"]
        want_rows[f"b{i}"] = (cfg.num_groups, G2_CS_SLOTS,
                              G2_CS_MAX_SEQ if w is None
                              else min(w, G2_CS_MAX_SEQ),
                              cfg.num_kv_heads, cfg.resolved_head_dim)
    for name in names:
        make = functools.partial(ContinuousEngine, params, cfg,
                                 POLICIES[name](), **kw)
        eng = make()
        rows = {b: tuple(eng._caches[b]["k"].shape) for b in eng._caches}
        if rows != want_rows:
            raise AssertionError(f"{arch} slab cache leaves {rows}, "
                                 f"expected {want_rows}")
        before = dict(build.LAUNCHES)
        torch.cuda.synchronize()
        out, wall = cs_serve(eng, reqs)
        torch.cuda.synchronize()
        moved = {k: build.LAUNCHES.get(k, 0) - before.get(k, 0)
                 for k in KERNELS}
        st = eng.stats()
        cuts = len(transformer.segment_bounds(
            cfg.num_groups, POLICIES[name]().num_stages)) - 1
        forwards = st["completed"] + st["ticks"]
        want = {k: (forwards * cuts if k in POLICY_KERNELS[name] else 0)
                for k in KERNELS}
        if moved != want:
            raise AssertionError(f"{arch} continuous {name}: launches "
                                 f"{moved}, expected {want} ({st})")
        assert all(((t >= 0) & (t < cfg.vocab_size)).all()
                   for t in out.values())
        log("# big serve " + json.dumps({
            "arch": cfg.arch_id, "engine": "continuous (slab)",
            "policy": name, "card": smi, "cache_k_rows": rows,
            "prompts": list(G2_CS_PROMPTS), "wall_s": wall,
            "tok_per_s": sum(len(t) for t in out.values()) / wall,
            "launches": {k: v for k, v in moved.items() if v},
            **{k: st[k] for k in ("mean_ttft_s", "slot_utilization",
                                  "ticks")}}))
        del eng
        ref, gaps, tops = cs_gap_run(torch, make, reqs, tops=True)
        cs_parts(out, ref, gaps, f"{arch} slab/{name} 8-tick chunks vs "
                 "single ticks", smi, tops)
        alone = cs_static(np, params, cfg, POLICIES[name](), reqs,
                          max_prompt=max(G2_CS_PROMPTS),
                          max_seq=G2_CS_MAX_SEQ)
        cs_parts(alone, ref, gaps, f"{arch} slab/{name} vs each request "
                 "alone (static engine)", smi, tops)


def check_big_against_cpu(torch, smi):
    """gemma2's and pixtral's smoke models, the same params and batch
    (pixtral's with random patch embeddings) on the card and on the CPU:
    eval logits within 2**-5 of their largest magnitude, one q4q8 step's
    loss within 0.05 and gradient within 0.3 of its norm
    (tests/test_torch_archs.py's bounds)."""
    from repro_torch.configs.registry import get
    from repro_torch.core.boundary import init_boundary_state
    from repro_torch.core.policy import POLICIES
    from repro_torch.models import transformer
    from repro_torch.optim.optimizers import OptimizerConfig, init_opt_state
    from repro_torch.train.steps import make_lm_train_step
    for arch in BIG_TRAIN:
        cfg = get(arch, smoke=True)
        params = transformer.init_params(torch.Generator().manual_seed(1),
                                         cfg)
        gen = torch.Generator().manual_seed(2)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 32),
                                         generator=gen)}
        if cfg.frontend == "vision":
            batch["patch_embeds"] = torch.randn(
                (4, cfg.num_patches, cfg.d_model),
                generator=gen).to(torch.bfloat16)
        policy = POLICIES["q4q8"]()
        opt = OptimizerConfig(kind="adamw", lr=1e-3, weight_decay=0.01,
                              schedule="cosine", t_max=2, grad_clip=1.0)
        cuts = len(transformer.segment_bounds(cfg.num_groups,
                                              policy.num_stages)) - 1
        res = {}
        for dev in ("cpu", "cuda"):
            p, b = _tree_to(params, dev), _tree_to(batch, dev)
            with torch.no_grad():
                logits = transformer.forward_eval(p, b, cfg).float().cpu()
            bst = [init_boundary_state(policy.at(i), (32, cfg.d_model),
                                       batch=4, dtype=torch.bfloat16,
                                       device=dev) for i in range(cuts)]
            grads = []
            with first_gradient(grads):
                _, _, _, m = make_lm_train_step(cfg, policy, opt)(
                    p, init_opt_state(opt, p), bst, b,
                    torch.arange(4, device=dev))
            res[dev] = (logits, float(m["loss"]), _tree_to(grads[0], "cpu"))
        (lc, loss_c, gc), (lg, loss_g, gg) = res["cpu"], res["cuda"]
        if not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"{arch} smoke: non-finite logits on the "
                                 "card")
        gap = (lg - lc).abs().max().item()
        bound = 2.0 ** -5 * lc.abs().max().item()
        rel = tree_rel_gap(gg, gc)
        if not (gap <= bound and abs(loss_g - loss_c) <= 0.05
                and rel <= 0.3):
            raise AssertionError(
                f"{arch} smoke, card vs CPU: logits gap {gap} (bound "
                f"{bound}), q4q8 loss {loss_g} vs {loss_c}, gradient "
                f"{rel}")
        log("# big smoke card vs CPU " + json.dumps({
            "arch": cfg.arch_id, "card": smi, "logit_gap": gap,
            "logit_bound": bound, "q4q8_loss": [loss_g, loss_c],
            "q4q8_grad_rel_gap": rel}))


def big_models(torch, np, build, smi):
    """Phase 13: gemma2-27b and pixtral-12b at full width (4 layers each)
    through the simulated compressed cuts and through serving; then each
    smoke model on the card against the CPU.  Returns the launches of
    the phase's main paths."""
    import dataclasses
    from repro_torch.configs.registry import get
    from repro_torch.models import transformer
    from repro_torch.models.config import param_count
    from repro_torch.serve.engine import ContinuousEngine
    t0 = time.perf_counter()
    build.reset_launches()                  # the phase 13 paths start here
    rng = np.random.RandomState(4)
    for arch in BIG_TRAIN:
        cfg = dataclasses.replace(get(arch), num_layers=BIG_LAYERS)
        log(f"# big {arch}: {param_count(cfg)} parameters at full width, "
            f"{BIG_LAYERS} layers, {cfg.num_groups} groups")
        for name in BIG_TRAIN[arch][2]:
            big_train_run(torch, build, cfg, arch, name, smi,
                          profile_step=3 if name == "q4q8" else None)
        params = transformer.init_params(
            torch.Generator(device="cuda").manual_seed(0), cfg)
        if arch == "gemma2-27b":
            prompts = [rng.randint(0, cfg.vocab_size, n) for n in G2_PROMPTS]
            for name in BIG_SERVE:
                big_static(torch, np, build, params, cfg, name, prompts, smi)
            big_continuous(torch, np, build, params, cfg, smi)
        else:
            prompts = [rng.randint(0, cfg.vocab_size, n) for n in PX_PROMPTS]
            big_static(torch, np, build, params, cfg, "q4q8", prompts, smi)
            try:
                ContinuousEngine(params, cfg)
            except ValueError as e:
                if "continuous batching needs maskable left-padding" not in \
                        str(e):
                    raise
                log(f"# big continuous: pixtral refused: {e}")
            else:
                raise AssertionError("pixtral: ContinuousEngine was not "
                                     "refused")
        del params
        _free(torch)
    torch.cuda.synchronize()
    launches = {k: build.LAUNCHES.get(k, 0) for k in KERNELS}  # read here
    log(f"# phase 13 launches {launches} ({time.perf_counter() - t0:.1f} s)")
    check_big_against_cpu(torch, smi)
    return launches


# ---------------------------------------------------------------------------
# phase 14: Mixture-of-Experts (models/moe.py) through mixtral-8x7b and
# llama4-maverick-400b-a17b at full width
# ---------------------------------------------------------------------------

# the registry configs at full width, depth cut with dataclasses.replace:
# mixtral 2 of its 32 layers (2 MoE groups, 8 experts top-2: the 4-stage
# presets stop at the 2 groups, 1 cut), llama4 4 of its 48 (2 (dense, MoE)
# groups, 128 experts top-1 and a shared expert, 1 cut)
MOE_LAYERS = {"mixtral-8x7b": 2, "llama4-maverick-400b-a17b": 4}
# mixtral trains 1 x 8,192 tokens (two routing groups of 4,096, twice the
# window): the training cut's launches of a step, forward and backward at
# its one cut
MOE_TRAIN = {"mixtral-8x7b": (1, 8192, ("none", "q4q8", "top10"), 2)}
# mixtral serves as gemma2 does (G2_PROMPTS, the slab recipe); llama4
# static on two prompts, then through the paged engine: 3 requests behind
# a 256-token shared prefix, 2 slots, prefill chunks of 128 tokens
L4_PROMPTS = (300, 200)
L4_PAGED_SHARED, L4_PAGED_TAILS = 256, (44, 100, 20)
L4_PAGED = dict(num_slots=2, max_seq=1024, prefix_cache=True,
                prefill_chunk=128, page_size=16)
# phase 2 at phase 14's shapes: mixtral's cut, and the q4q8 serving rows
# (the static prefills left-padded to the longest prompt, the decodes)
MOE_CUTS = {"mixtral cut (1, 8192*4096) bf16": (1, 8192 * 4096)}
# every row shape phase 14 feeds the q4 pair (moe_models fails on any
# other): the slab engine's inserts at their buckets (512, 1,024, 4,100)
# and the static engine serving each of those requests alone (cs_static:
# 2 rows a bucket), the paged engine's prefill chunks (a (1, d) payload a
# token: boundary_wire_eval_tokens)
MOE_Q4 = {
    "mixtral static prefill (2, 4100*4096) f32": ((2, 4100 * 4096), True),
    "mixtral slab insert (1, 4100*4096) f32": ((1, 4100 * 4096), True),
    "mixtral slab insert (1, 1024*4096) f32": ((1, 1024 * 4096), False),
    "mixtral slab insert (1, 512*4096) f32": ((1, 512 * 4096), False),
    "mixtral alone prefill (2, 1024*4096) f32": ((2, 1024 * 4096), False),
    "mixtral alone prefill (2, 512*4096) f32": ((2, 512 * 4096), False),
    "mixtral decode (2, 4096) f32": ((2, 4096), False),
    "llama4 static prefill (2, 300*5120) f32": ((2, 300 * 5120), True),
    "llama4 paged prefill chunk (128, 5120) f32": ((128, 5120), True),
    "llama4 decode (2, 5120) f32": ((2, 5120), False)}
# the smoke models card vs CPU: params seeds (the batch is seed + 1); a
# routed row is near its CPU row within MOE_ROW_TOL in probability
# (tests/test_torch_archs.py's); the q4q8 step's aux within
# MOE_AUX_RTOL of the CPU's, relative (PERF.md: readings up to 2.1e-3)
MOE_CPU_SEEDS = (1, 2, 3, 4, 5, 6)
MOE_ROW_TOL = 2.0 ** -3
MOE_AUX_RTOL = 1e-2


class RoutingReplay:
    """Model-level MoE parity: a first run's routing pinned into a second
    run of the same model, row by row, each parting shown to be a
    near-tie.  The first run is the port on the CPU (``recording``: the
    port's own ``moe._top_k`` feeds ``keep``) or, in the CPU tests, the
    JAX package (a ``jax.debug.callback`` feeds ``keep``, ``barrier`` is
    ``jax.effects_barrier``).  ``top_k`` takes ``moe._top_k``'s place;
    ``own`` is the port's real ``moe._top_k``, passed in, since a
    replay left in place by an earlier run would otherwise be wrapped.

    The hidden state entering a router is bf16 and differs between the
    runs by ulps (and, past a compressed cut, by a code step now and
    then), so a token whose k-th and (k+1)-th experts are that close can
    route apart, which moves its output far past the bf16 bound.  Each
    routing call of the second run is matched to the recorded call of
    its shape with the most rows near its own (a row's largest
    probability difference within ``row_tol``; then the least median),
    and row (token) r to its row r: by position, since left-padding and
    idle slots make rows that are near copies of each other.  A near row
    takes the recorded choices; where one differs from its own, the
    parting must be a near-tie: its log-probability margin between its
    own and the recorded expert, at the first place they differ, no
    larger than the call's noise, the largest shift of any pairwise
    log-probability difference between the runs,
    max_e(dlp_e) - min_e(dlp_e) with dlp = log p_second - log p_first,
    over the call's near rows that did not part (where it has none, over
    every such row so far).  A row farther away (a stream after a
    parting) keeps its own routing.  ``partings`` lists (margin, the
    call's noise) of each; ``hits`` / ``misses`` count the near and the
    other rows."""

    def __init__(self, torch, own, row_tol, barrier=None):
        self.torch, self.own, self.row_tol = torch, own, row_tol
        self.barrier, self.recording = barrier, False
        self.bank, self.partings, self.noise = {}, [], 0.0
        self.hits = self.misses = 0

    def keep(self, probs, idx):
        """Record one routing call: probs (..., E), idx (..., k)."""
        import numpy as np
        e, k = probs.shape[-1], idx.shape[-1]
        probs = np.asarray(probs).reshape(-1, e)
        self.bank.setdefault(probs.shape + (k,), []).append(
            (probs, np.asarray(idx).reshape(-1, k)))

    def top_k(self, probs, k):
        import numpy as np
        torch = self.torch
        vals, idx, onehot = self.own(probs, k)
        e = probs.shape[-1]
        got = probs.detach().float().cpu().reshape(-1, e).numpy()
        own = idx.cpu().reshape(-1, k).numpy()
        if self.recording:
            self.keep(got, own)
            return vals, idx, onehot
        if self.barrier is not None:
            self.barrier()
        calls = self.bank.get(got.shape + (k,), [])
        rows = [np.abs(rp - got).max(1) for rp, _ in calls]
        score = [(-int((r <= self.row_tol).sum()), float(np.median(r)))
                 for r in rows]
        best = min(range(len(calls)), key=score.__getitem__, default=None)
        if best is None or score[best][0] == 0:
            self.misses += len(got)
            return vals, idx, onehot
        rp, ref = calls[best]
        near = rows[best] <= self.row_tol
        self.hits += int(near.sum())
        self.misses += int((~near).sum())
        parted = near & (ref != own).any(1)
        tiny = np.finfo(np.float32).tiny
        dlp = np.log(np.maximum(got, tiny)) - np.log(np.maximum(rp, tiny))
        noise = (dlp.max(1) - dlp.min(1))[near & ~parted]
        if noise.size:
            bound = float(noise.max())
            self.noise = max(self.noise, bound)
        else:
            bound = self.noise
        for r in np.nonzero(parted)[0]:
            c = int(np.argmax(ref[r] != own[r]))
            margin = float(np.log(got[r, own[r, c]])
                           - np.log(got[r, ref[r, c]]))
            if not 0 <= margin <= bound:
                raise AssertionError(
                    f"routing parts at a margin {margin} over the call's "
                    f"noise {bound}: {own[r]}, recorded {ref[r]}")
            self.partings.append((margin, bound))
        if not parted.any():
            return vals, idx, onehot
        pinned = np.where(parted[:, None], ref, own).astype(np.int64)
        idx = torch.from_numpy(pinned).reshape(idx.shape).to(idx.device)
        onehot = torch.nn.functional.one_hot(idx, e).to(probs.dtype)
        return (probs[..., None, :] * onehot).sum(-1), idx, onehot


def check_moe_against_cpu(torch, smi):
    """mixtral's and llama4's smoke models on ``MOE_CPU_SEEDS``, the same
    params and batch on the CPU (routing recorded) and on the card
    (routing pinned, each parting a near-tie; see RoutingReplay): eval
    logits within 2**-5 of their largest magnitude, one q4q8 step's loss
    within 0.05 and gradient within 0.3 of its norm
    (tests/test_torch_archs.py's bounds), its aux within ``MOE_AUX_RTOL``
    of the CPU's.  llama4's smoke step is its only training on the
    card."""
    from repro_torch.configs.registry import get
    from repro_torch.core.boundary import init_boundary_state
    from repro_torch.core.policy import POLICIES
    from repro_torch.models import moe, transformer
    from repro_torch.optim.optimizers import OptimizerConfig, init_opt_state
    from repro_torch.train.steps import make_lm_train_step
    real = moe._top_k
    try:
        for arch, seed in ((a, s) for a in MOE_LAYERS for s in MOE_CPU_SEEDS):
            cfg = get(arch, smoke=True)
            params = transformer.init_params(
                torch.Generator().manual_seed(seed), cfg)
            gen = torch.Generator().manual_seed(seed + 1)
            batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 32),
                                             generator=gen)}
            policy = POLICIES["q4q8"]()
            opt = OptimizerConfig(kind="adamw", lr=1e-3, weight_decay=0.01,
                                  schedule="cosine", t_max=2, grad_clip=1.0)
            cuts = len(transformer.segment_bounds(cfg.num_groups,
                                                  policy.num_stages)) - 1
            pins = RoutingReplay(torch, real, MOE_ROW_TOL)
            moe._top_k = pins.top_k
            res = {}
            for first, dev in ((True, "cpu"), (False, "cuda")):
                pins.recording = first
                p, b = _tree_to(params, dev), _tree_to(batch, dev)
                with torch.no_grad():
                    logits = transformer.forward_eval(p, b, cfg).float().cpu()
                bst = [init_boundary_state(policy.at(i), (32, cfg.d_model),
                                           batch=4, dtype=torch.bfloat16,
                                           device=dev) for i in range(cuts)]
                grads = []
                with first_gradient(grads):
                    _, _, _, m = make_lm_train_step(cfg, policy, opt)(
                        p, init_opt_state(opt, p), bst, b,
                        torch.arange(4, device=dev))
                res[first] = (logits, float(m["loss"]), float(m["aux"]),
                              _tree_to(grads[0], "cpu"))
            recorded = sum(len(r) for calls in pins.bank.values()
                           for r, _ in calls)
            if pins.misses or pins.hits != recorded:
                raise AssertionError(
                    f"{arch} seed {seed}: {pins.hits} routed rows on the "
                    f"card near their CPU rows, {pins.misses} not, "
                    f"{recorded} recorded")
            (lc, loss_c, aux_c, gc), (lg, loss_g, aux_g, gg) = \
                res[True], res[False]
            if not bool(torch.isfinite(lg).all()):
                raise AssertionError(f"{arch} smoke: non-finite logits on "
                                     "the card")
            gap = (lg - lc).abs().max().item()
            bound = 2.0 ** -5 * lc.abs().max().item()
            rel = tree_rel_gap(gg, gc)
            aux_rel = abs(aux_g - aux_c) / abs(aux_c)
            if not (gap <= bound and abs(loss_g - loss_c) <= 0.05
                    and aux_rel <= MOE_AUX_RTOL and rel <= 0.3):
                raise AssertionError(
                    f"{arch} smoke seed {seed}, card vs CPU: logits gap "
                    f"{gap} (bound {bound}), q4q8 loss {loss_g} vs "
                    f"{loss_c}, aux {aux_g} vs {aux_c}, gradient {rel}")
            log("# moe smoke card vs CPU " + json.dumps({
                "arch": cfg.arch_id, "seed": seed, "card": smi,
                "logit_gap": gap, "logit_bound": bound,
                "q4q8_loss": [loss_g, loss_c], "q4q8_aux": [aux_g, aux_c],
                "q4q8_aux_rel_gap": aux_rel, "q4q8_grad_rel_gap": rel,
                "routed_rows": pins.hits,
                "routing_partings": pins.partings}))
    finally:
        moe._top_k = real


def moe_paged(torch, np, build, params, cfg, smi):
    """llama4 through the paged ``ContinuousEngine`` under q4q8: three
    requests behind a shared prefix (prefix hits, chunked prefill: its
    MoE meets ``decode_span`` over pages), launches exact (each cut packs
    once a forward: a prefill chunk or a decode tick), every page back in
    the pool, its peak memory."""
    from repro_torch.core.policy import POLICIES
    from repro_torch.models import transformer
    from repro_torch.serve.engine import ContinuousEngine
    rng = np.random.RandomState(6)
    shared = rng.randint(0, cfg.vocab_size, L4_PAGED_SHARED)
    reqs = [(np.concatenate([shared, rng.randint(0, cfg.vocab_size, n)])
             .astype(np.int64), BIG_NEW, i)
            for i, n in enumerate(L4_PAGED_TAILS)]
    policy = POLICIES["q4q8"]()
    torch.cuda.reset_peak_memory_stats()
    eng = ContinuousEngine(params, cfg, policy, **L4_PAGED)
    before = dict(build.LAUNCHES)
    torch.cuda.synchronize()
    out, wall = cs_serve(eng, reqs)
    torch.cuda.synchronize()
    moved = {k: build.LAUNCHES.get(k, 0) - before.get(k, 0) for k in KERNELS}
    st = eng.stats()
    cuts = len(transformer.segment_bounds(cfg.num_groups,
                                          policy.num_stages)) - 1
    forwards = st["prefill_chunks"] + st["ticks"]
    want = {k: (forwards * cuts if k in POLICY_KERNELS["q4q8"] else 0)
            for k in KERNELS}
    if moved != want:
        raise AssertionError(f"llama4 paged: launches {moved}, expected "
                             f"{want} ({st})")
    eng.pages.check_invariants()
    if eng.pages.active_pages() or st["prefix_hits"] < 1:
        raise AssertionError(f"llama4 paged: {eng.pages.active_pages()} "
                             f"pages active after the drain, stats {st}")
    if not all(len(t) == BIG_NEW and ((t >= 0) & (t < cfg.vocab_size)).all()
               for t in out.values()):
        raise AssertionError(f"llama4 paged: tokens {out}")
    log("# moe serve " + json.dumps({
        "arch": cfg.arch_id, "engine": "continuous (paged)",
        "policy": "q4q8", "card": smi, "shared_prefix": L4_PAGED_SHARED,
        "tails": list(L4_PAGED_TAILS), "wall_s": wall,
        "tok_per_s": sum(len(t) for t in out.values()) / wall,
        "launches": {k: v for k, v in moved.items() if v},
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        **{k: st[k] for k in ("mean_ttft_s", "ticks", "prefill_chunks",
                              "prefix_hits", "prefix_hit_tokens")}}))


@contextlib.contextmanager
def q4_row_shapes(seen: set):
    """Add the (rows, n) of every q4 pack and unpack through the codecs
    to ``seen`` while the block runs."""
    from repro_torch.transport import codecs
    pack, unpack = codecs.pack4_wire, codecs.unpack4_wire

    def pack_spy(flat, mn, sc):
        seen.add(tuple(flat.shape))
        return pack(flat, mn, sc)

    def unpack_spy(packed, mn, sc, n):
        seen.add((packed.shape[0], n))
        return unpack(packed, mn, sc, n)

    codecs.pack4_wire, codecs.unpack4_wire = pack_spy, unpack_spy
    try:
        yield
    finally:
        codecs.pack4_wire, codecs.unpack4_wire = pack, unpack


def moe_models(torch, np, build, smi):
    """Phase 14: mixtral-8x7b (2 layers) trained under none / q4q8 / top10
    and served statically and through the slab engine, its paged pool
    refused; llama4-maverick (4 layers, 128 experts drawn slice by slice
    on the card) served statically and through the paged engine under
    q4q8; then each smoke model on the card against the CPU.  Returns the
    launches of the phase's main paths, and fails if they fed the q4
    pair a row shape that phase 2 did not check."""
    t0 = time.perf_counter()
    build.reset_launches()                  # the phase 14 paths start here
    rng = np.random.RandomState(4)
    q4_rows = set()
    with q4_row_shapes(q4_rows):
        moe_paths(torch, np, build, smi, rng)
    torch.cuda.synchronize()
    launches = {k: build.LAUNCHES.get(k, 0) for k in KERNELS}  # read here
    log(f"# phase 14 launches {launches} ({time.perf_counter() - t0:.1f} s)")
    unchecked = q4_rows - {shape for shape, _ in MOE_Q4.values()}
    if unchecked:
        raise AssertionError(f"phase 14 fed the q4 pair rows {unchecked} "
                             "that phase 2 did not check (MOE_Q4)")
    log(f"# phase 14 q4 rows, each checked in phase 2: {sorted(q4_rows)}")
    check_moe_against_cpu(torch, smi)
    return launches


def moe_paths(torch, np, build, smi, rng):
    """Phase 14's main paths (see moe_models)."""
    import dataclasses
    from repro_torch.configs.registry import get
    from repro_torch.models import transformer
    from repro_torch.models.config import param_count
    from repro_torch.serve import pages as PG
    for arch, layers in MOE_LAYERS.items():
        cfg = dataclasses.replace(get(arch), num_layers=layers)
        log(f"# moe {arch}: {param_count(cfg)} parameters at full width, "
            f"{layers} layers, {cfg.num_groups} groups, "
            f"{cfg.num_experts} experts top-{cfg.top_k}")
        for name in (MOE_TRAIN[arch][2] if arch in MOE_TRAIN else ()):
            big_train_run(torch, build, cfg, arch, name, smi,
                          profile_step=3 if name == "q4q8" else None)
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        params = transformer.init_params(
            torch.Generator(device="cuda").manual_seed(0), cfg)
        torch.cuda.synchronize()
        log(f"# moe {arch}: params drawn on the card in "
            f"{time.perf_counter() - t1:.1f} s, max_memory_allocated "
            f"{torch.cuda.max_memory_allocated()}")
        if arch == "mixtral-8x7b":
            prompts = [rng.randint(0, cfg.vocab_size, n) for n in G2_PROMPTS]
            for name in BIG_SERVE:
                big_static(torch, np, build, params, cfg, name, prompts, smi)
            try:
                PG.init_page_pool(transformer, cfg, 8, 16, device="cuda")
            except ValueError as e:
                if "sliding-window" not in str(e):
                    raise
                log(f"# moe mixtral: the page pool refused: {e}")
            else:
                raise AssertionError("mixtral: the page pool was not "
                                     "refused")
            big_continuous(torch, np, build, params, cfg, smi,
                           names=("q4q8",))
        else:
            prompts = [rng.randint(0, cfg.vocab_size, n) for n in L4_PROMPTS]
            torch.cuda.reset_peak_memory_stats()
            big_static(torch, np, build, params, cfg, "q4q8", prompts, smi)
            log(f"# moe llama4 static: max_memory_allocated "
                f"{torch.cuda.max_memory_allocated()}")
            moe_paged(torch, np, build, params, cfg, smi)
        del params
        _free(torch)


# ---------------------------------------------------------------------------
# phase 15: linear attention (models/linattn.py) through rwkv6-3b and
# hymba-1.5b at full width
# ---------------------------------------------------------------------------

# training: the registry configs at full width, depth cut from 32 to 4
# layers with dataclasses.replace (4 groups: the 4-stage presets, 3
# cuts), 1 x 4,096 tokens (128 chunks of 32 a layer; hymba's window
# 1,024), the training cut's launches of a compressing step: forward and
# backward at each cut
REC_LAYERS = 4
REC_TRAIN = {"rwkv6-3b": (1, 4096, ("none", "q4q8", "top10"), 6),
             "hymba-1.5b": (1, 4096, ("none", "q4q8", "top10"), 6)}
# serving at full depth (32 layers, 3 cuts): two equal-length prompts of
# 1,100 tokens (34 chunks of 32 and a padded one; hymba's ring of 1,024
# rows wraps) and 16 new tokens, the static engine under none / q4q8
REC_PROMPTS = (1100, 1100)
# phase 2 at phase 15's shapes: the training cuts, and every row shape
# the q4q8 serving wire is fed (the static prefills, the decode ticks)
REC_CUTS = {"rwkv6 cut (1, 4096*2560) bf16": (1, 4096 * 2560),
            "hymba cut (1, 4096*1600) bf16": (1, 4096 * 1600)}
REC_Q4 = {
    "rwkv6 static prefill (2, 1100*2560) f32": ((2, 1100 * 2560), True),
    "rwkv6 decode (2, 2560) f32": ((2, 2560), False),
    "hymba static prefill (2, 1100*1600) f32": ((2, 1100 * 1600), True),
    "hymba decode (2, 1600) f32": ((2, 1600), False)}
# the smoke models card vs CPU: 45-token rows (a chunk and a padded one),
# 8 served tokens after a 45-token prompt (hymba's ring of 16 wraps)
REC_CPU_SEQ, REC_CPU_NEW = 45, 8


def greedy_gaps(torch, params, cfg, toks, new, mod=None, extra=None):
    """The static engine's greedy loop (prefill, then ``decode_step``
    with the real wire, uncompressed) on ``toks``: each row's tokens, and
    its top-2 logit gap and top logit at every step.  ``mod``: the model
    module (``transformer`` by default); ``extra``: more of the prefill's
    batch (the encoder-decoder's frame embeddings)."""
    from repro_torch.models import transformer
    mod = mod or transformer
    out, gaps, tops = [], {}, {}
    with torch.inference_mode():
        logits, caches = mod.prefill(
            params, {"tokens": toks, **(extra or {})}, cfg,
            cache_len=toks.shape[1] + new, wire=True)
        logits = logits[:, -1]
        for step in range(new):
            top2 = torch.topk(logits.float(), 2).values.cpu()
            for r in range(toks.shape[0]):
                gaps[(r, step)] = float(top2[r, 0] - top2[r, 1])
                tops[(r, step)] = float(top2[r, 0])
            tok = torch.argmax(logits, dim=-1)
            out.append(tok.cpu())
            if step < new - 1:
                logits, caches = mod.decode_step(
                    params, tok, caches, toks.shape[1] + step, cfg,
                    wire=True)
    gen = torch.stack(out, dim=1).numpy()
    return {r: gen[r] for r in range(gen.shape[0])}, gaps, tops


def check_rec_against_cpu(torch, smi):
    """rwkv6's and hymba's smoke models, the same params and batch on the
    card and on the CPU: eval logits within 2**-5 of their largest
    magnitude, one q4q8 step's loss within 0.05 and gradient within 0.3
    of its norm (tests/test_torch_archs.py's bounds), and the served
    greedy tokens (the carried recurrent state on the card) equal but for
    a parting at a near-tie of the CPU's logits (``cs_parts``)."""
    from repro_torch.configs.registry import get
    from repro_torch.core.boundary import init_boundary_state
    from repro_torch.core.policy import POLICIES
    from repro_torch.models import transformer
    from repro_torch.optim.optimizers import OptimizerConfig, init_opt_state
    from repro_torch.train.steps import make_lm_train_step
    for arch in REC_TRAIN:
        cfg = get(arch, smoke=True)
        params = transformer.init_params(torch.Generator().manual_seed(1),
                                         cfg)
        gen = torch.Generator().manual_seed(2)
        toks = torch.randint(0, cfg.vocab_size, (4, REC_CPU_SEQ),
                             generator=gen)
        policy = POLICIES["q4q8"]()
        opt = OptimizerConfig(kind="adamw", lr=1e-3, weight_decay=0.01,
                              schedule="cosine", t_max=2, grad_clip=1.0)
        cuts = len(transformer.segment_bounds(cfg.num_groups,
                                              policy.num_stages)) - 1
        res = {}
        for dev in ("cpu", "cuda"):
            p, b = _tree_to(params, dev), {"tokens": toks.to(dev)}
            with torch.no_grad():
                logits = transformer.forward_eval(p, b, cfg).float().cpu()
            bst = [init_boundary_state(policy.at(i),
                                       (REC_CPU_SEQ, cfg.d_model), batch=4,
                                       dtype=torch.bfloat16, device=dev)
                   for i in range(cuts)]
            grads = []
            with first_gradient(grads):
                _, _, _, m = make_lm_train_step(cfg, policy, opt)(
                    p, init_opt_state(opt, p), bst, b,
                    torch.arange(4, device=dev))
            served = greedy_gaps(torch, p, cfg, toks[:2].to(dev),
                                 REC_CPU_NEW)
            res[dev] = (logits, float(m["loss"]), _tree_to(grads[0], "cpu"),
                        served)
        (lc, loss_c, gc, sc), (lg, loss_g, gg, sg) = res["cpu"], res["cuda"]
        if not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"{arch} smoke: non-finite logits on the "
                                 "card")
        gap = (lg - lc).abs().max().item()
        bound = 2.0 ** -5 * lc.abs().max().item()
        rel = tree_rel_gap(gg, gc)
        if not (gap <= bound and abs(loss_g - loss_c) <= 0.05
                and rel <= 0.3):
            raise AssertionError(
                f"{arch} smoke, card vs CPU: logits gap {gap} (bound "
                f"{bound}), q4q8 loss {loss_g} vs {loss_c}, gradient "
                f"{rel}")
        parts = cs_parts(sg[0], sc[0], sc[1], f"{arch} smoke served, card "
                         "vs CPU", smi, sc[2])
        log("# recurrent smoke card vs CPU " + json.dumps({
            "arch": cfg.arch_id, "card": smi, "logit_gap": gap,
            "logit_bound": bound, "q4q8_loss": [loss_g, loss_c],
            "q4q8_grad_rel_gap": rel, "served_partings": parts,
            "served_tokens[0]": sg[0][0].tolist()}))


def rec_models(torch, np, build, smi):
    """Phase 15: rwkv6-3b and hymba-1.5b at full width, trained (4 layers)
    under none / q4q8 / top10 and served (32 layers) statically under
    none / q4q8, ``ContinuousEngine`` refused; then each smoke model on
    the card against the CPU.  Returns the launches of the phase's main
    paths, and fails if they fed the q4 pair a row shape that phase 2 did
    not check."""
    t0 = time.perf_counter()
    build.reset_launches()                  # the phase 15 paths start here
    q4_rows = set()
    with q4_row_shapes(q4_rows):
        rec_paths(torch, np, build, smi)
    torch.cuda.synchronize()
    launches = {k: build.LAUNCHES.get(k, 0) for k in KERNELS}  # read here
    log(f"# phase 15 launches {launches} ({time.perf_counter() - t0:.1f} s)")
    unchecked = q4_rows - {shape for shape, _ in REC_Q4.values()}
    if unchecked:
        raise AssertionError(f"phase 15 fed the q4 pair rows {unchecked} "
                             "that phase 2 did not check (REC_Q4)")
    log(f"# phase 15 q4 rows, each checked in phase 2: {sorted(q4_rows)}")
    check_rec_against_cpu(torch, smi)
    return launches


def rec_paths(torch, np, build, smi):
    """Phase 15's main paths (see rec_models)."""
    import dataclasses
    from repro_torch.configs.registry import get
    from repro_torch.models import transformer
    from repro_torch.models.config import param_count
    from repro_torch.serve.engine import ContinuousEngine
    rng = np.random.RandomState(4)
    for arch in REC_TRAIN:
        cfg = dataclasses.replace(get(arch), num_layers=REC_LAYERS)
        log(f"# recurrent {arch}: {param_count(cfg)} parameters at full "
            f"width, {REC_LAYERS} layers, {cfg.num_groups} groups")
        for name in REC_TRAIN[arch][2]:
            big_train_run(torch, build, cfg, arch, name, smi,
                          profile_step=3 if name == "q4q8" else None)
        cfg = get(arch)
        torch.cuda.reset_peak_memory_stats()
        params = transformer.init_params(
            torch.Generator(device="cuda").manual_seed(0), cfg)
        log(f"# recurrent {arch}: {param_count(cfg)} parameters at full "
            f"width and depth ({cfg.num_layers} layers) drawn on the card")
        prompts = [rng.randint(0, cfg.vocab_size, n) for n in REC_PROMPTS]
        for name in BIG_SERVE:
            big_static(torch, np, build, params, cfg, name, prompts, smi)
        log(f"# recurrent {arch} static: max_memory_allocated "
            f"{torch.cuda.max_memory_allocated()}")
        try:
            ContinuousEngine(params, cfg)
        except ValueError as e:
            if "continuous batching needs maskable left-padding" not in \
                    str(e):
                raise
            log(f"# recurrent continuous: {arch} refused: {e}")
        else:
            raise AssertionError(f"{arch}: ContinuousEngine was not "
                                 "refused")
        del params
        _free(torch)


# ---------------------------------------------------------------------------
# phase 16: the encoder-decoder stack (models/encdec.py) through
# whisper-small at full width and depth
# ---------------------------------------------------------------------------

# the registry config unchanged: 12 encoder and 12 decoder layers, d 768,
# 12 heads of 64, d_ff 3,072, vocab 51,865, 1,500 encoder frames.
# Training: 8 x 448 decoder tokens against 1,500 frames (seeded N(0, 1)
# bf16 frame embeddings from numpy), the 4-stage presets: 3 decoder cuts
# and the memory hop, whose forward launches the cut kernel once a step
# (its backward is torch reductions), the cuts forward and backward: 7
# launches a step (batch, seq, policies, launches a step; big_train_run)
WH_BATCH, WH_SEQ = 8, 448
WH_TRAIN = {"whisper-small": (WH_BATCH, WH_SEQ, ("none", "q4q8", "top10"),
                              7)}
# run -> (policy, DP lanes (q8 reduce), grad_accum pieces), 2 steps each
WH_EXTRA = {"dp2 q8/q4q8": ("q4q8", 2, 1), "q4q8/accum2": ("q4q8", 1, 2)}
# serving: the static engine, 4 prompts of 4 tokens (whisper's start
# sequence), 64 new tokens, 448 cache rows, throughput_probe
WH_SERVE_BATCH, WH_PROMPT, WH_NEW, WH_MAX_SEQ = 4, 4, 64, 448
WH_GEN = 16                   # tokens of the greedy generate beside the probe
WH_SERVE = ("none", "q4q8", "top10")
ENC_ROW = 1500 * 768          # one request's memory on the serving wire
# phase 2 at phase 16's shapes: the memory hop and a decoder cut at the
# train batch (timed) and at a DP lane's / an accumulation piece's 4 rows
# (checked only), bf16
WH_CUTS = {"whisper memory hop (8, 1500*768) bf16": (8, ENC_ROW),
           "whisper decoder cut (8, 448*768) bf16": (8, 448 * 768)}
WH_LANE_CUTS = {"whisper memory hop (4, 1500*768) bf16": (4, ENC_ROW),
                "whisper decoder cut (4, 448*768) bf16": (4, 448 * 768)}
# ... the q4 pair at every row shape the q4q8 serving wire is fed: the
# memory packed per request, the prefill's and a decode tick's cuts
WH_Q4 = {"whisper served memory (4, 1500*768) f32": ((4, ENC_ROW), True),
         "whisper prefill (4, 4*768) f32": ((4, 4 * 768), False),
         "whisper decode (4, 768) f32": ((4, 768), False)}
# ... and the TopK select at the top10 wire's rows (bf16, k = 10%)
WH_SELECT = {"whisper served memory (4, 1500*768) bf16": (4, ENC_ROW),
             "whisper prefill (4, 4*768) bf16": (4, 4 * 768),
             "whisper decode (4, 768) bf16": (4, 768)}
WH_CPU_SEQ, WH_CPU_NEW = 24, 8


def whisper_leaves(torch):
    """The full-width whisper-small parameter leaves' shapes and dtypes,
    in ``tree_leaves`` order."""
    from repro_torch.configs.registry import get
    from repro_torch.models import encdec
    from repro_torch.optim.optimizers import tree_leaves
    params = encdec.init_params(
        torch.Generator(device="cuda").manual_seed(0), get("whisper-small"))
    leaves = tree_leaves(params)
    return [tuple(a.shape) for a in leaves], [a.dtype for a in leaves]


def whisper_kernels(torch, D, ops, pack4, topk, codecs, collectives,
                    framing):
    """Phase 2 at phase 16's shapes: the cut kernels at the memory hop and
    the decoder cuts (and the hop under autograd, ``check_hop_ad``), the
    q4 pair and the select at the serving wire's rows, bit-exact against their plain versions, the train batch's cuts
    and the memory's rows timed;
    the DP q8 payload of whisper's 32 gradient leaves framed and decoded
    + summed at dp = 2, bit-exact against the plain version and the
    unfused loop."""
    err, timed = big_kernels(torch, D, ops, pack4, WH_CUTS, WH_Q4)
    check_hop_ad(torch, ops)
    gen = torch.Generator(device="cuda").manual_seed(12)
    lanes = {label: torch.randn(shape, generator=gen, device="cuda")
             .to(torch.bfloat16) for label, shape in WH_LANE_CUTS.items()}
    for name, e in check_cut_kernels(torch, D, ops, lanes).items():
        err[name] = max(err[name], e)
    del lanes
    for label, shape in WH_SELECT.items():
        x = torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)
        check_select(torch, D, topk, x)
        log(f"# select kernels bit-exact vs plain: {label}")
        if shape[1] == ENC_ROW:
            timed[label] = time_select(torch, D, topk, [x])
            for name, row in timed[label].items():
                log(f"# {name} {label}: " + json.dumps(row))
        del x
    from repro_torch.kernels import dp_reduce
    shapes, _ = whisper_leaves(torch)
    bank, plans, structs, leaves = dp_bank(torch, codecs, collectives, "q8",
                                           shapes, 13, dp=2)
    sizes = [a.numel() for a in leaves]
    segs, plain = kernel_and_plain(
        torch, D, lambda: framing.unframe_parts(bank[-1], sizes))
    max_err(torch, segs, plain)
    max_err(torch, segs, leaves)
    got, want = kernel_and_plain(
        torch, D, lambda: dp_reduce.decode_sum_fused(bank, plans, 2))
    err["decode_sum_fused"] = max_err(torch, got, want)
    c = codecs.get_codec("q8")
    loop = [None] * len(shapes)
    for s in range(2):
        pls = codecs.unfuse_payload(bank[s], structs)
        for i, shape in enumerate(shapes):
            m = collectives.unpack_grad_leaf(c, pls[i], shape)
            loop[i] = m if loop[i] is None else loop[i] + m
    max_err(torch, [a.reshape(l.shape) for a, l in zip(got, loop)], loop)
    log(f"# decode_sum_fused and unframe_parts bit-exact vs plain and the "
        f"unfused loop: whisper-small q8 DP payload dp=2 ({len(sizes)} "
        f"segments, {bank.shape[1]} B)")
    del bank, leaves, got, want, loop
    torch.cuda.empty_cache()
    return err, timed


# the memory hop under autograd, forward and backward, card against CPU
WH_HOP = {"whisper memory hop (8, 1500*768) bf16": (8, ENC_ROW),
          "whisper memory hop (4, 1500*768) bf16": (4, ENC_ROW)}


def check_hop_ad(torch, ops):
    """The memory hop as phase 16 differentiates it: a bare ``Compressor``
    call (q4, q8, top10) through ``ops.quant_dequant_ad`` /
    ``topk_block_ad``, forward and backward for a seeded bf16 cotangent
    at ``WH_HOP``'s shapes, its first tile tied (integers -3..3) and its
    second constant, on the card and on CPU copies of the same inputs.
    C(x) bitwise; TopK's gradient bitwise; the quantizers' gradient
    non-zero on the same entries (each tile's min and max) and within
    one bf16 ulp (2**-7 relative) of the CPU's, plus 2**-16 of the
    tile's sum of |g|: the f32 tile sums run in another order on each
    device, which matters only where a sum nearly cancels."""
    from repro_torch.core.compressors import Compressor
    gen = torch.Generator(device="cuda").manual_seed(14)
    comps = {"q4": Compressor("quant", bits=4),
             "q8": Compressor("quant", bits=8),
             "top10": Compressor("topk", k_frac=0.1)}
    for label, (m, n) in WH_HOP.items():
        x = torch.randn((m, n), generator=gen, device="cuda")
        bm, bn = ops._tile(x)
        x[:bm, :bn] = torch.randint(-3, 4, (bm, bn), generator=gen,
                                    device="cuda").float()
        x[:bm, bn:2 * bn] = 3.25
        x = x.to(torch.bfloat16)
        g = torch.randn((m, n), generator=gen, device="cuda").to(
            torch.bfloat16)
        worst = {}
        for name, comp in comps.items():
            res = []
            for dev in ("cuda", "cpu"):
                xi = x.detach().to(dev).requires_grad_()
                y = comp(xi)
                y.backward(g.to(dev))
                res.append((y.detach().cpu(), xi.grad.cpu()))
            (y_card, g_card), (y_cpu, g_cpu) = res
            max_err(torch, [y_card], [y_cpu])
            if comp.kind == "topk":
                max_err(torch, [g_card], [g_cpu])
                worst[name] = 0.0
                continue
            a, b = g_card.float(), g_cpu.float()
            if not torch.equal(a != 0, b != 0):
                raise AssertionError(f"hop gradient {name} {label}: "
                                     "non-zero on other entries")
            sums = g.cpu().float().abs().reshape(
                m // bm, bm, n // bn, bn).sum(dim=(1, 3), keepdim=True)
            tol = 2.0 ** -7 * b.abs() + 2.0 ** -16 * sums.expand(
                m // bm, bm, n // bn, bn).reshape(m, n)
            over = (a - b).abs() / tol
            if bool((over > 1).any()):
                raise AssertionError(f"hop gradient {name} {label}: "
                                     f"{over.max().item()} of its bound")
            worst[name] = over.max().item()
        log(f"# memory hop forward and backward, card vs CPU: {label} "
            "(gap / bound: " + json.dumps(worst) + ")")


def wh_train(torch, build, cfg, name, smi, embeds, **kw):
    """A :func:`big_train_run` of whisper-small on the frame embeddings
    ``embeds`` whose first gradient must reach the encoder (through the
    memory hop's backward): its ``enc_layers`` leaves' |g|_1 non-zero and
    finite, printed."""
    from repro_torch.optim.optimizers import tree_leaves
    grads = []
    with first_gradient(grads):
        big_train_run(torch, build, cfg, cfg.arch_id, name, smi,
                      enc_embeds=embeds, **kw)
    enc = sum(float(g.float().abs().sum())
              for g in tree_leaves(grads[0]["enc_layers"]))
    del grads
    _free(torch)
    if not (enc and math.isfinite(enc)):
        raise AssertionError(f"whisper {name}: the encoder's gradient "
                             f"|g|_1 {enc} at step 1")
    log("# whisper encoder gradient " + json.dumps(
        {"run": name, "card": smi, "encoder_grad_l1_step1": enc}))


def wh_enc_embeds(torch, np, cfg, step):
    """Step ``step``'s seeded N(0, 1) frame embeddings (numpy
    ``RandomState``), bf16 on the card."""
    x = np.random.RandomState(100 + step).standard_normal(
        (WH_BATCH, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return torch.from_numpy(x).to("cuda").to(torch.bfloat16)


def wh_serve(torch, np, build, params, cfg, name, smi):
    """``ServeEngine.throughput_probe`` (a warm 2-token run, then a
    timed prefill and 63 decode steps) and greedy ``generate`` of 16
    tokens on 4 equal-length 4-token prompts: launches exact (each
    forward packs the 3 decoder cuts, a prefill the memory too), tokens
    in the vocabulary, the refusal of a mixed-length batch."""
    from repro_torch.core.policy import POLICIES
    from repro_torch.serve.engine import Request, ServeEngine
    eng = ServeEngine(params, cfg, POLICIES[name](),
                      max_batch=WH_SERVE_BATCH, max_seq=WH_MAX_SEQ)
    before = dict(build.LAUNCHES)
    probe = eng.throughput_probe(WH_SERVE_BATCH, WH_PROMPT, WH_NEW)
    rng = np.random.RandomState(5)
    reqs = [Request(rng.randint(0, cfg.vocab_size, WH_PROMPT), WH_GEN)
            for _ in range(WH_SERVE_BATCH)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    toks = np.stack([r.out for r in out])
    assert toks.shape == (WH_SERVE_BATCH, WH_GEN)
    assert ((toks >= 0) & (toks < cfg.vocab_size)).all()
    moved = {k: build.LAUNCHES.get(k, 0) - before.get(k, 0) for k in KERNELS}
    # prefills (probe warm-up, probe, generate) pack 4 cuts, decodes 3
    forwards = 3 * 4 + 3 * ((2 - 1) + (WH_NEW - 1) + (WH_GEN - 1))
    want = {k: (forwards if k in POLICY_KERNELS[name] else 0)
            for k in KERNELS}
    if moved != want:
        raise AssertionError(f"whisper static {name}: launches {moved}, "
                             f"expected {want}")
    try:
        eng.generate([Request(np.arange(1, 6), 2),
                      Request(np.arange(1, 9), 2)])
    except ValueError as e:
        if "['enc-dec'] cannot support" not in str(e):
            raise
    else:
        raise AssertionError("whisper: a mixed-length batch was served")
    log("# whisper serve " + json.dumps({
        "arch": cfg.arch_id, "engine": "static", "policy": name,
        "card": smi, **probe, "generate_wall_s": wall,
        "launches": {k: v for k, v in moved.items() if v},
        "tokens[0][:8]": toks[0, :8].tolist()}))
    return probe


def check_whisper_against_cpu(torch, np, smi):
    """whisper-small's smoke model, the same params and batch (seeded
    frame embeddings) on the card and on the CPU: eval logits within
    2**-5 of their largest magnitude, one q4q8 step's loss within 0.05
    and gradient within 0.3 of its norm with the ``enc_layers`` leaves in
    the tree (the encoder's leaves alone are printed, not bounded: only
    each memory tile's min and max pass the q4 hop's gradient on, so one
    flipped code there moves them by up to 0.33 of their norm between the
    port and the reference on the CPU), and the served greedy tokens
    equal but for a parting at a near-tie of the CPU's logits
    (``cs_parts``)."""
    from repro_torch.configs.registry import get
    from repro_torch.core.boundary import init_boundary_state
    from repro_torch.core.policy import POLICIES
    from repro_torch.models import encdec
    from repro_torch.optim.optimizers import OptimizerConfig, init_opt_state
    from repro_torch.train.steps import make_lm_train_step
    cfg = get("whisper-small", smoke=True)
    params = encdec.init_params(torch.Generator().manual_seed(1), cfg)
    gen = torch.Generator().manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (4, WH_CPU_SEQ), generator=gen)
    emb = torch.from_numpy(np.random.RandomState(3).standard_normal(
        (4, cfg.enc_seq, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    policy = POLICIES["q4q8"]()
    opt = OptimizerConfig(kind="adamw", lr=1e-3, weight_decay=0.01,
                          schedule="cosine", t_max=2, grad_clip=1.0)
    res = {}
    for dev in ("cpu", "cuda"):
        p = _tree_to(params, dev)
        b = {"tokens": toks.to(dev), "enc_embeds": emb.to(dev)}
        with torch.no_grad():
            logits = encdec.forward_eval(p, b, cfg).float().cpu()
        bst = [init_boundary_state(policy.at(0), (WH_CPU_SEQ, cfg.d_model),
                                   batch=4, dtype=torch.bfloat16, device=dev)]
        grads = []
        with first_gradient(grads):
            _, _, _, m = make_lm_train_step(cfg, policy, opt)(
                p, init_opt_state(opt, p), bst, b,
                torch.arange(4, device=dev))
        served = greedy_gaps(torch, p, cfg, toks[:2].to(dev), WH_CPU_NEW,
                             mod=encdec,
                             extra={"enc_embeds": emb[:2].to(dev)})
        res[dev] = (logits, float(m["loss"]), _tree_to(grads[0], "cpu"),
                    served)
    (lc, loss_c, gc, sc), (lg, loss_g, gg, sg) = res["cpu"], res["cuda"]
    if not bool(torch.isfinite(lg).all()):
        raise AssertionError("whisper smoke: non-finite logits on the card")
    gap = (lg - lc).abs().max().item()
    bound = 2.0 ** -5 * lc.abs().max().item()
    rel = tree_rel_gap(gg, gc)
    enc = tree_rel_gap(gg["enc_layers"], gc["enc_layers"])
    enc_l1 = sum(float(a.float().abs().sum())
                 for _, a in _leaves(gg["enc_layers"]))
    if not (gap <= bound and abs(loss_g - loss_c) <= 0.05 and rel <= 0.3
            and enc_l1 > 0):
        raise AssertionError(
            f"whisper smoke, card vs CPU: logits gap {gap} (bound {bound}), "
            f"q4q8 loss {loss_g} vs {loss_c}, gradient {rel}, the card's "
            f"encoder gradient |g|_1 {enc_l1}")
    parts = cs_parts(sg[0], sc[0], sc[1], "whisper smoke served, card vs "
                     "CPU", smi, sc[2])
    log("# whisper smoke card vs CPU " + json.dumps({
        "arch": cfg.arch_id, "card": smi, "logit_gap": gap,
        "logit_bound": bound, "q4q8_loss": [loss_g, loss_c],
        "q4q8_grad_rel_gap": rel, "q4q8_encoder_grad_rel_gap": enc,
        "q4q8_encoder_grad_l1_card": enc_l1,
        "served_partings": parts, "served_tokens[0]": sg[0][0].tolist()}))


@contextlib.contextmanager
def select_row_shapes(seen: set):
    """Add the (rows, n, k) of every TopK select through the codecs to
    ``seen`` while the block runs."""
    from repro_torch.transport import codecs
    real = codecs.topk_select_wire

    def spy(flat, k):
        seen.add((*flat.shape, k))
        return real(flat, k)

    codecs.topk_select_wire = spy
    try:
        yield
    finally:
        codecs.topk_select_wire = real


@contextlib.contextmanager
def cut_shapes(seen: set):
    """Add the flattened (rows, n) of every training-cut kernel call
    through the ops layer to ``seen`` while the block runs."""
    from repro_torch.kernels import ops
    real = {n: getattr(ops, n) for n in ("quant_dequant_op",
                                        "topk_block_op")}

    def spy(name):
        def call(x, arg):
            seen.add((x.shape[0], x[0].numel()))
            return real[name](x, arg)
        return call

    for name in real:
        setattr(ops, name, spy(name))
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(ops, name, fn)


def whisper_models(torch, np, build, smi):
    """Phase 16: whisper-small at full width and depth, trained under
    none / q4q8 / top10, data-parallel and with gradient accumulation,
    served statically under none / q4q8 / top10 with ``ContinuousEngine``
    refused; then its smoke model on the card against the CPU, beside
    ``launch/train`` and ``launch/serve --arch whisper-small`` as
    concurrent subprocesses.  Returns the launches of the phase's main
    paths, and fails if they fed a kernel a shape that phase 2 did not
    check."""
    t0 = time.perf_counter()
    build.reset_launches()                  # the phase 16 paths start here
    seen_q4, seen_sel, seen_cut = set(), set(), set()
    with q4_row_shapes(seen_q4), select_row_shapes(seen_sel), \
            cut_shapes(seen_cut):
        whisper_paths(torch, np, build, smi)
    torch.cuda.synchronize()
    launches = {k: build.LAUNCHES.get(k, 0) for k in KERNELS}  # read here
    log(f"# phase 16 launches {launches} ({time.perf_counter() - t0:.1f} s)")
    checked = {
        "q4 pair": (seen_q4, {shape for shape, _ in WH_Q4.values()}),
        "select": (seen_sel, {(*s, select_k(s[1]))
                              for s in WH_SELECT.values()}),
        "cut kernels": (seen_cut, {*WH_CUTS.values(),
                                   *WH_LANE_CUTS.values()})}
    for what, (seen, ok) in checked.items():
        if seen - ok:
            raise AssertionError(f"phase 16 fed the {what} {seen - ok} "
                                 "that phase 2 did not check")
        log(f"# phase 16 {what} shapes, each checked in phase 2: "
            f"{sorted(seen)}")
    procs = launchers({
        "train": ["repro_torch.launch.train", "--arch", "whisper-small",
                  "--steps", "2", "--batch", "8", "--seq", "448",
                  "--policy", "q4q8", "--log-every", "1"],
        "serve": ["repro_torch.launch.serve", "--arch", "whisper-small",
                  "--policy", "q4q8", "--batch", "4", "--prompt-len", "4",
                  "--new-tokens", "16", "--max-seq", "448"]})
    with reaped([procs]):
        check_whisper_against_cpu(torch, np, smi)
        res = launcher_results(procs)
    for name, (code, recs, out) in res.items():
        if code != 0:
            raise AssertionError(f"launch/{name} --arch whisper-small "
                                 f"exited {code}:\n{out}")
        log(f"# launch/{name} --arch whisper-small " + json.dumps(
            {"card": smi, "records": recs}))
    if not (len(res["train"][1]) == 2 and all(
            math.isfinite(r["loss"]) for r in res["train"][1])):
        raise AssertionError(f"launch/train whisper: {res['train'][2]}")
    if "['enc-dec'] cannot mask left-padding -> static engine" not in \
            res["serve"][2] or res["serve"][1][0]["engine"] != "static":
        raise AssertionError(f"launch/serve whisper: {res['serve'][2]}")
    log(f"# phase 16 done in {time.perf_counter() - t0:.1f} s")
    return launches


def whisper_paths(torch, np, build, smi):
    """Phase 16's main paths (see whisper_models)."""
    from repro_torch.configs.registry import get
    from repro_torch.models import encdec
    from repro_torch.models.config import param_count
    from repro_torch.serve.engine import ContinuousEngine
    cfg = get("whisper-small")
    log(f"# whisper-small: {param_count(cfg)} parameters + dec_pos "
        f"{cfg.max_seq * cfg.d_model}, {cfg.enc_layers} encoder and "
        f"{cfg.num_layers} decoder layers, d {cfg.d_model}, "
        f"{cfg.enc_seq} frames")
    embeds = [wh_enc_embeds(torch, np, cfg, i) for i in range(BIG_STEPS)]
    for name in WH_TRAIN[cfg.arch_id][2]:
        wh_train(torch, build, cfg, name, smi, embeds,
                 profile_step=3 if name == "q4q8" else None)
    for name, (pname, dp, accum) in WH_EXTRA.items():
        wh_train(torch, build, cfg, name, smi, embeds, steps=2, dp=dp,
                 grad_accum=accum, policy_name=pname)
    del embeds
    torch.cuda.reset_peak_memory_stats()
    params = encdec.init_params(
        torch.Generator(device="cuda").manual_seed(0), cfg)
    for name in WH_SERVE:
        wh_serve(torch, np, build, params, cfg, name, smi)
    log(f"# whisper static: max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()}")
    try:
        ContinuousEngine(params, cfg)
    except ValueError as e:
        if "continuous batching needs maskable left-padding" not in str(e):
            raise
        log(f"# whisper continuous: refused: {e}")
    else:
        raise AssertionError("whisper: ContinuousEngine was not refused")
    del params
    _free(torch)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def tree_rel_gap(got, want) -> float:
    """|got - want| / |want| over every leaf of two trees of one layout,
    in float64."""
    num = den = 0.0
    for (_, a), (_, b) in zip(_leaves(got), _leaves(want), strict=True):
        a, b = a.double(), b.double()
        num += (a - b).square().sum().item()
        den += b.square().sum().item()
    return math.sqrt(num / max(den, 1e-300))


@contextlib.contextmanager
def first_gradient(into: list):
    """While open, a train step's first call to its optimizer also puts
    the gradient tree it was given into ``into``."""
    import repro_torch.train.steps as TS
    real = TS.apply_updates

    def spy(o, p, g, s, **kw):
        if not into:
            into.append(g)
        return real(o, p, g, s, **kw)

    TS.apply_updates = spy
    try:
        yield
    finally:
        TS.apply_updates = real


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


# ---------------------------------------------------------------------------
# phase 17: the tooling -- the dry run held against the card, the examples
# ---------------------------------------------------------------------------

# (arch, layers or None for full depth, (batch, seq), (--mesh, --wire) or
# None for the simulated cuts, pipeline microbatches); q4q8 cuts throughout
TOOL_CONFIGS = {
    "gpt2-small simulated": ("gpt2-small", None, (8, 1024), None, None),
    "gpt2-small data=2,stage=2": ("gpt2-small", None, (8, 1024),
                                  ("data=2,stage=2", "data=q8"), 2),
    "glm4-9b 2 layers simulated": ("glm4-9b", 2, (1, 4096), None, None),
}
EXAMPLES = ("quickstart", "pipeline_stages", "serve_compressed",
            "finetune_index_reuse")
DRYRUN_ARGV = ["repro_torch.launch.dryrun", "--all", "--policy", "q4q8",
               "--json", "chiprun_out/dryrun.json"]
# each kernel's use site: (module that calls it, its home module)
CHECKED_SITES = {
    "quant_dequant": ("repro_torch.kernels.ops",
                      "repro_torch.kernels.quantize"),
    "topk_block": ("repro_torch.kernels.ops", "repro_torch.kernels.topk_mask"),
    "quantize_wire": ("repro_torch.transport.codecs",
                      "repro_torch.kernels.quantize"),
    "pack4_wire": ("repro_torch.transport.codecs", "repro_torch.kernels.pack4"),
    "unpack4_wire": ("repro_torch.transport.codecs",
                     "repro_torch.kernels.pack4"),
    "topk_select_wire": ("repro_torch.transport.codecs",
                         "repro_torch.kernels.topk_select"),
    "frame_parts": ("repro_torch.transport.codecs",
                    "repro_torch.kernels.framing"),
    "unframe_parts": ("repro_torch.transport.codecs",
                      "repro_torch.kernels.framing"),
    "decode_sum_fused": ("repro_torch.transport.collectives",
                         "repro_torch.kernels.dp_reduce"),
}
# the kernels each checked wrapper launches
CHECKED_LAUNCHES = {"topk_select_wire": ("topk_threshold", "topk_compact")}


def _out_tensors(torch, out):
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in _out_tensors(torch, o)]


def bit_gap(torch, got, want):
    """(outputs equal as integer bits, largest absolute difference)."""
    gs, ws = _out_tensors(torch, got), _out_tensors(torch, want)
    same, err = len(gs) == len(ws), 0.0
    for g, w in zip(gs, ws):
        if g.shape != w.shape or g.dtype != w.dtype:
            return False, math.inf
        gb = g.contiguous().reshape(-1).view(torch.uint8)
        wb = w.contiguous().reshape(-1).view(torch.uint8)
        if not torch.equal(gb, wb):
            same = False
            if g.numel():
                err = max(err, (g.double() - w.double()).abs().nan_to_num(
                    math.inf).max().item())
    return same, err


@contextlib.contextmanager
def checked_kernels(torch, record: dict):
    """While open, every kernel wrapper called on card tensors through its
    use site is also run as its plain version on the same inputs and the
    two are held bit-exact: ``record`` gets each wrapper's calls, largest
    difference and differing calls (the plain runs launch nothing)."""
    import importlib
    saved = []
    for name, (site, home) in CHECKED_SITES.items():
        mod = importlib.import_module(site)
        real = getattr(mod, name)
        plain = getattr(importlib.import_module(home), name + "_plain")

        def wrap(*args, _real=real, _plain=plain, _name=name, **kw):
            out = _real(*args, **kw)
            tensors = [a for x in args for a in (
                x if isinstance(x, (list, tuple)) else [x])
                if isinstance(a, torch.Tensor)]
            if any(t.is_cuda for t in tensors):
                same, err = bit_gap(torch, out, _plain(*args, **kw))
                r = record.setdefault(_name, {"calls": 0, "max_abs_err": 0.0,
                                              "differ": 0})
                r["calls"] += 1
                r["max_abs_err"] = max(r["max_abs_err"], err)
                r["differ"] += not same
            return out
        setattr(mod, name, wrap)
        saved.append((mod, name, real))
    try:
        yield record
    finally:
        for mod, name, real in saved:
            setattr(mod, name, real)


def check_record(record: dict, launches: dict, what: str) -> None:
    """Fail if a wrapper's kernel disagreed with its plain version, or a
    kernel launched on ``what`` without a checked call."""
    bad = {k: r for k, r in record.items()
           if isinstance(r, dict) and r["differ"]}
    if bad:
        raise AssertionError(f"{what}: kernel != plain version: {bad}")
    for name, n in launches.items():
        site = next((w for w, ks in CHECKED_LAUNCHES.items() if name in ks),
                    name)
        if n and not record.get(site, {}).get("calls"):
            raise AssertionError(f"{what}: {name} launched {n} times with "
                                 "no call checked against its plain version")


def run_checked_example(path: str) -> None:
    """Run one torch example on the card with every kernel call held
    bit-exact against its plain version; print the example's output, then
    ``# example launches {...}`` and ``# example checks {...}`` (with the
    example's seconds in process)."""
    import runpy
    import torch
    from repro_torch.kernels import _build
    record = {}
    sys.argv = [path]
    t0 = time.perf_counter()
    with checked_kernels(torch, record):
        runpy.run_path(path, run_name="__main__")
    torch.cuda.synchronize()
    launches = {k: _build.LAUNCHES.get(k, 0) for k in KERNELS}
    record["seconds"] = round(time.perf_counter() - t0, 1)
    print("# example launches " + json.dumps(launches), flush=True)
    print("# example checks " + json.dumps(record), flush=True)
    check_record(record, launches, path)


def start_dryrun():
    """``launch/dryrun --all --policy q4q8`` as a subprocess with no card
    in sight (it runs on the meta device), its output into
    ``chiprun_out/dryrun.log``; returns (process, start time, log path)."""
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    log_path = out / "dryrun.log"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    with open(log_path, "w") as f:
        proc = subprocess.Popen([sys.executable, "-m", *DRYRUN_ARGV],
                                cwd=ROOT, env=env, stdout=f,
                                stderr=subprocess.STDOUT, text=True)
    atexit.register(lambda: proc.poll() is None and (proc.kill(),
                                                     proc.wait()))
    return proc, time.perf_counter(), log_path


def tool_config(torch, name, smi, record):
    """One configuration's step shape only (``dryrun.train_case`` on
    meta under ``run_shape_only``) and on the card (seed-0 weights, the
    same step under FlopCounterMode and ``wire_record``): the matmul flops,
    the arguments' bytes on a 1 x 1 grid against the card tree's
    ``nbytes``, and each ring's wire bytes and launches, all equal."""
    import dataclasses
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs.registry import get
    from repro_torch.core.parallel import spec_from_cli
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.input_specs import InputShape
    from repro_torch.launch.mesh import LaneGrid, make_local_mesh
    arch, layers, (batch, seq), mesh, mb = TOOL_CONFIGS[name]
    cfg = get(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    shape = InputShape(name, "train", seq, batch)
    spec = spec_from_cli(*mesh) if mesh else None
    kw = dict(parallel=spec, pipeline_microbatches=mb)
    policy = DR.POLICIES["q4q8"]
    t0 = time.perf_counter()
    step, args = DR.train_case(cfg, shape, policy, "meta", **kw)
    meta = DR.run_shape_only(step, *args)
    meta_bytes = DR.train_argument_bytes(make_local_mesh(), args)
    del step, args
    t1 = time.perf_counter()
    step, args = DR.train_case(cfg, shape, policy, "cuda", **kw)
    fc = FlopCounterMode(display=False)
    with checked_kernels(torch, record), DR.wire_record() as events, fc:
        out = step(*args)
    torch.cuda.synchronize()
    card_bytes = DR.nbytes(args)
    loss = float(out[-1]["loss"])
    grid = LaneGrid(
        tuple(spec.axis(a).size for a in ("data", "stage", "tensor"))
        if spec else (1,), ("data", "stage", "tensor") if spec else ("data",))
    got = {"flops": meta.matmul_flops, "bytes": meta_bytes,
           "wire_bytes": DR.collective_bytes(meta.events),
           "wire_launches": DR.collective_counts(meta.events, grid, True)}
    want = {"flops": fc.get_total_flops(), "bytes": card_bytes,
            "wire_bytes": DR.collective_bytes(events),
            "wire_launches": DR.collective_counts(events, grid, True)}
    axis_bytes = {}
    for e in events:
        axis, _, nb = DR.wire_terms(e)
        axis_bytes[axis] = axis_bytes.get(axis, 0) + nb
    # the stage ring's bytes are the step's own count of them
    wire = out[-1].get("wire", {})
    if "stage" in axis_bytes and axis_bytes["stage"] != (
            wire["fw_bytes"] + wire["bw_bytes"]):
        raise AssertionError(f"{name}: stage ring {axis_bytes['stage']} B "
                             f"!= the step's {wire}")
    if got != want or not math.isfinite(loss):
        raise AssertionError(f"{name}: shape only {got} != card {want} "
                             f"(loss {loss})")
    if mesh and not events:
        raise AssertionError(f"{name}: the traced step emitted no wire event")
    log(f"# tooling {name} " + json.dumps({
        "card": smi, "batch": batch, "seq": seq, "layers": cfg.num_layers,
        "matmul_flops": want["flops"], "argument_bytes": card_bytes,
        "wire_bytes": want["wire_bytes"], "wire_launches": want[
            "wire_launches"], "axis_bytes": axis_bytes, "loss": loss,
        "shape_only_s": round(t1 - t0, 3),
        "card_s": round(time.perf_counter() - t1, 3)}))
    del step, args, out
    _free(torch)


def tooling(torch, build, smi, dryrun):
    """Phase 17: the four torch examples on the card as concurrent
    subprocesses (each kernel call held bit-exact against its plain
    version there), the dry run's flops, argument bytes and wire record
    against the card on ``TOOL_CONFIGS``, then the ``--all`` dry run
    started at the beginning of the run joined (``# 40/40 OK``, rc 0).
    Returns the launches of the phase's paths, the examples' included."""
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {n: subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]);"
         " import chip_smoke; chip_smoke.run_checked_example(sys.argv[2])",
         str(ROOT), str(ROOT / "examples" / f"{n}_torch.py")], cwd=ROOT,
        env=env, text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for n in EXAMPLES}
    with reaped([procs]):
        build.reset_launches()              # the phase 17 paths start here
        record = {}
        for name in TOOL_CONFIGS:
            tool_config(torch, name, smi, record)
        torch.cuda.synchronize()
        launches = {k: build.LAUNCHES.get(k, 0) for k in KERNELS}  # read here
        check_record(record, launches, "phase 17 configurations")
        log(f"# tooling checks {json.dumps(record)} "
            f"({time.perf_counter() - t0:.1f} s)")
        ex_launches = {}
        for n, proc in procs.items():
            out, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"example {n} exited {proc.returncode}"
                                     f":\n{out[-3000:]}\n{err[-3000:]}")
            lines = out.splitlines()
            for ln in lines[:-2]:
                log(f"# example {n} | {ln}")
            got = json.loads(lines[-2][len("# example launches "):])
            log(f"# example {n} launches {json.dumps(got)}; checked "
                f"{lines[-1][len('# example checks '):]}")
            ex_launches[n] = got
        log(f"# examples done at {time.perf_counter() - t0:.1f} s")
    for counts in ex_launches.values():
        for k, v in counts.items():
            launches[k] += v
    proc, start, log_path = dryrun
    rc = proc.wait(timeout=900)
    lines = log_path.read_text().splitlines()
    reps = [json.loads(ln) for ln in lines if ln.startswith("{")]
    if rc != 0 or lines[-1] != "# 40/40 OK":
        raise AssertionError(f"dryrun --all exited {rc}: {lines[-3:]}")
    slow = sorted((r for r in reps if not r["skipped"]),
                  key=lambda r: -r["run_s"])[:3]
    log("# tooling dryrun --all --policy q4q8 " + json.dumps({
        "card": smi, "last": lines[-1], "reports": len(reps),
        "skipped": sum(r["skipped"] for r in reps),
        "sum_run_s": round(sum(r.get("run_s", 0) for r in reps), 1),
        "joined_after_s": round(time.perf_counter() - start, 1),
        "slowest": [(r["arch"], r["shape"], r["run_s"]) for r in slow]}))
    log(f"# phase 17 launches {launches}; done in "
        f"{time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 18: the pipeline's stages as processes
# ---------------------------------------------------------------------------

# run -> ranks (stages); each held against phase 5's run of the same name
RANK_RUNS = {"gpipe/q4q8": 4, "gpipe/top10reuse": 4, "1f1b/aqsgd": 4,
             "interleaved/q4q8": 2}
# steps 2-3 part from phase 5 by the clip's gathered norm (one float32 ulp
# at step 1: tests/test_torch_pipeline_ranks.py) and by what that moves
# in the compressed steps after it
RANK_LOSS_RTOL = 1e-3
# the launcher's step 2 ppl (exp of the unrounded loss, after the clip's
# gathered norm): read 44592.56 against 44592.30, 5.8e-6 relative
RANK_LAUNCH_PPL_RTOL = 2e-5
HOP_ITERS = 20
RANK_WAIT_S = 900             # a rank that is never set going gives up
RANK_LAUNCH = ["repro_torch.launch.train", "--transport", "pipeline",
               "--stages", "2", "--steps", "2"]


def _on_card(torch, tree, what):
    """Every tensor of ``tree`` (dicts, lists, FeedbackStates) on the card."""
    from repro_torch.core.feedback import FeedbackState
    if isinstance(tree, FeedbackState):
        tree = [tree.resid, tree.mirror, tree.agg]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        for v in tree:
            _on_card(torch, v, what)
    elif torch.is_tensor(tree) and not tree.is_cuda:
        raise AssertionError(f"{what}: a tensor on {tree.device}")


def rank_run(torch, cfg, full, name, group, build):
    """Phase 5's run ``name`` as this rank of ``group`` builds it: its own
    params, AdamW state and buffer rows, the same seed-0 stream.  Returns
    its losses (the last rank's), each step's launches, wire counters
    (summed over the ranks) and CUDA-synchronised wall seconds."""
    from repro_torch.launch.train import synthetic_stream
    from repro_torch.optim.optimizers import OptimizerConfig, init_opt_state
    from repro_torch.train.loop import _pipeline_bstates
    from repro_torch.train.steps import make_lm_train_step, stage_params

    _, _, sched, v = PIPE_RUNS[name][:4]
    stages = PIPE_STAGES // v
    policy = pipe_policy(name, stages)
    opt = OptimizerConfig(kind="adamw", lr=1e-3, weight_decay=0.01,
                          schedule="cosine", t_max=PIPE_STEPS, grad_clip=1.0)
    dev = group.device
    params = stage_params(full, group.rank, stages, v)
    bstates = _pipeline_bstates(policy, (PIPE_SEQ, cfg.d_model),
                                batch=PIPE_BATCH, microbatches=PIPE_MB,
                                num_samples=PIPE_SAMPLES,
                                dtype=torch.bfloat16, virtual_stages=v,
                                device=dev, stage=group.rank)
    step = make_lm_train_step(cfg, policy, opt, transport="pipeline",
                              pipeline_microbatches=PIPE_MB, schedule=sched,
                              virtual_stages=v, group=group)
    stream = synthetic_stream(cfg, PIPE_BATCH, PIPE_SEQ, 0,
                              num_samples=PIPE_SAMPLES)
    opt_state = init_opt_state(opt, params)
    out = {"losses": [], "launches": [], "wire": [], "seconds": [],
           "started": time.time()}
    for _ in range(PIPE_STEPS):
        toks, ids = next(stream)
        batch = {"tokens": torch.from_numpy(toks).to(dev, torch.int64)}
        ids = torch.from_numpy(ids).to(dev)
        before = dict(build.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, bstates, m = step(params, opt_state, bstates,
                                             batch, ids)
        torch.cuda.synchronize()
        out["seconds"].append(time.perf_counter() - t0)
        out["losses"].append(None if m["loss"] is None
                             else float(m["loss"]))
        out["wire"].append(m["wire"])
        out["launches"].append({k: build.LAUNCHES.get(k, 0) - before.get(k, 0)
                                for k in KERNELS})
    _on_card(torch, [params, opt_state, bstates], f"{name} rank "
             f"{group.rank}")
    return out


def hop_ms(torch, group):
    """Ranks 0 and 1 time the host-staged hop of a full-width microbatch
    (CUDA-synchronised, ``HOP_ITERS`` each way): the q4 forward payload
    from 0 to 1, the tiled q8 backward payload from 1 to 0.  Returns
    this rank's times (ms) by codec, none on the other ranks."""
    from repro_torch.transport.codecs import get_codec, payload_struct
    if group.rank > 1:
        return {}
    x = torch.randn(MB_ROWS, device=group.device,
                    generator=torch.Generator(group.device).manual_seed(3)
                    ).to(torch.bfloat16)
    times = {}
    for codec, src, dst in (("q4", 0, 1), ("q8", 1, 0)):
        payload = get_codec(codec).pack(x)
        struct = payload_struct(payload)
        ms = times[codec] = []
        for _ in range(HOP_ITERS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if group.rank == src:
                group.send_payload(payload, dst)
            else:
                moved = group.recv_payload(struct, src)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        if group.rank == dst and not all(torch.equal(moved[k], a)
                                         for k, a in payload.items()):
            raise AssertionError(f"hop {codec}: a leaf changed on the wire")
    return times


def rank_groups(cards):
    """Phase 18's groups, run in turn by one spawn of 4 processes: (world,
    backend, runs).  A rank past a group's world leaves."""
    groups = [(w, "gloo", [n for n, ws in RANK_RUNS.items() if ws == w])
              for w in (4, 2)]
    if cards >= 4:
        groups.insert(1, (4, "nccl", ["gpipe/q4q8"]))
    return groups


def rank_worker(rank, groups, go, tmp):
    """One spawned process of phase 18: for each of ``groups`` that it is
    a rank of, joins the group (gloo: every rank on cuda:0 of a one-card
    machine; nccl: rank r on cuda:r), runs the group's runs on the card
    once the file ``go`` exists, and writes what it measured to ``tmp``.
    The kernels were built by the parent: it only loads them."""
    stamps = {"process": time.time()}
    import torch
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    from repro_torch.configs.registry import get
    from repro_torch.kernels import _build
    from repro_torch.models import transformer
    from repro_torch.transport.p2p import StageGroup
    stamps["imported"] = time.time()
    cfg = get("gpt2-small")
    res = {"runs": {}, "devices": [], "stamps": stamps}
    for i, (world, backend, names) in enumerate(groups):
        if rank >= world:
            break
        with StageGroup(rank, world, backend, device="cuda",
                        init_method=f"file://{tmp}/store{i}") as group:
            full = transformer.init_params(
                torch.Generator(device=group.device).manual_seed(0), cfg)
            res["devices"].append([backend, str(group.device),
                                   group.staged])
            stamps[f"group {i} ready"] = time.time()
            while not os.path.exists(go):
                if time.time() - stamps["process"] > RANK_WAIT_S:
                    raise RuntimeError("phase 18's ranks were never set "
                                       "going")
                time.sleep(0.05)
            for n in names:
                res["runs"][f"{n}@{backend}"] = rank_run(
                    torch, cfg, full, n, group, _build)
            if world > 2 and backend == "gloo":
                res["hop_ms"] = hop_ms(torch, group)
            stamps[f"group {i} done"] = time.time()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def spawn_ranks(groups, go, tmp):
    """Spawn phase 18's 4 processes (spawn, not fork: this process has
    CUDA up) without waiting for them."""
    import torch.multiprocessing as mp
    return mp.spawn(rank_worker, args=(groups, go, tmp),
                    nprocs=max(w for w, _, _ in groups), join=False)


def join_ranks(ctx, tmp, wall0, deadline, smi):
    """Join the spawned ranks by ``deadline`` (perf_counter) or kill them;
    returns each process's record, and logs when the slowest rank reached
    each point."""
    try:
        while not ctx.join(timeout=max(deadline - time.perf_counter(),
                                       0.1)):
            if time.perf_counter() >= deadline:
                raise AssertionError("phase 18: the ranks did not end in "
                                     "time")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    recs = []
    for r in range(len(ctx.processes)):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            recs.append(json.load(f))
    marks = {}
    for r in recs:
        for k, t in [*r["stamps"].items(),
                     *((f"run {n}", v["started"])
                       for n, v in r["runs"].items())]:
            marks[k] = max(marks.get(k, 0.0), t - wall0)
    log(f"# ranks timeline (s from the spawn, slowest rank; {smi}): "
        + json.dumps(dict(sorted(marks.items(), key=lambda kv: kv[1]))))
    return recs


def check_rank_run(name, recs, want, smi, backend):
    """Run ``name`` over its ranks against ``want``, phase 5's: step 1's
    loss bitwise, steps 2-3 within ``RANK_LOSS_RTOL``, bytes and hops
    exactly, launches summed over the ranks exactly; returns the summed
    launches."""
    runs = [r["runs"][f"{name}@{backend}"] for r in recs]
    losses = runs[-1]["losses"]
    if any(x is not None for r in runs[:-1] for x in r["losses"]):
        raise AssertionError(f"ranks {name}: a loss off the last rank")
    if losses[0] != want["losses"][0]:
        raise AssertionError(f"ranks {name}: step-1 loss {losses[0]} != "
                             f"phase 5's {want['losses'][0]}")
    for got, ref in zip(losses[1:], want["losses"][1:]):
        if not abs(got - ref) <= RANK_LOSS_RTOL * abs(ref):
            raise AssertionError(f"ranks {name}: losses {losses} vs phase "
                                 f"5's {want['losses']}")
    launches = []
    for i in range(PIPE_STEPS):
        if any(r["wire"][i] != want["wire"][i] for r in runs):
            raise AssertionError(f"ranks {name} step {i + 1}: wire "
                                 f"{runs[0]['wire'][i]} != phase 5's "
                                 f"{want['wire'][i]}")
        got = {k: sum(r["launches"][i][k] for r in runs) for k in KERNELS}
        if got != want["launches"][i]:
            raise AssertionError(f"ranks {name} step {i + 1}: launches "
                                 f"{got} != phase 5's "
                                 f"{want['launches'][i]}")
        launches.append(got)
    step_s = [max(r["seconds"][i] for r in runs) for i in range(PIPE_STEPS)]
    tok = PIPE_BATCH * PIPE_SEQ * (PIPE_STEPS - 1)
    log("# ranks " + json.dumps({
        "run": name, "card": smi, "ranks": len(recs), "backend": backend,
        "losses": losses, "phase5_losses": want["losses"],
        "launches_per_step": {k: v for k, v in launches[0].items() if v},
        "wire_per_step": runs[0]["wire"][0], "step_s": step_s,
        "phase5_step_s": want["seconds"],
        "tokens_per_s_steps_2_to_3": tok / sum(step_s[1:]),
        "phase5_tokens_per_s_steps_2_to_3": tok / sum(want["seconds"][1:])}))
    return {k: sum(s[k] for s in launches) for k in KERNELS}


def check_rank_launcher(ranks, one, smi):
    """The launcher's loss lines under ``torch.distributed.run`` against
    the one-process launcher's: step 1's line bitwise (its ppl is the exp
    of the unrounded loss), every step's rounded loss and bytes bitwise,
    step 2's ppl within ``RANK_LAUNCH_PPL_RTOL`` (the clip's gathered
    norm moved the params it runs from by a rounding)."""
    keys = ("step", "loss", "ppl", "fw_bytes", "bw_bytes")
    got = [{k: r[k] for k in keys} for r in ranks]
    want = [{k: r[k] for k in keys} for r in one]
    ok = (len(got) == len(want) == 2 and got[0] == want[0]
          and all(g[k] == w[k] for g, w in zip(got, want)
                  for k in ("step", "loss", "fw_bytes", "bw_bytes"))
          and abs(got[1]["ppl"] - want[1]["ppl"])
          <= RANK_LAUNCH_PPL_RTOL * want[1]["ppl"])
    if not ok:
        raise AssertionError(f"phase 18 launcher: ranks {got} vs one "
                             f"process {want}")
    log("# ranks launcher: torch.distributed.run --nproc-per-node 2 "
        "--dist-backend gloo against the one-process launcher: "
        + json.dumps({"card": smi, "ranks": got, "one_process": want}))


PendingRanks = namedtuple("PendingRanks", "ctx procs tmp go groups wall0 t0")


def start_stage_ranks(torch):
    """Start phase 18's background work while phase 17 runs: the launcher
    under ``torch.distributed.run`` (2 ranks, 2 full-width steps on the
    card) and the 4 rank processes, which import, join their first group,
    draw their params and then wait for the file ``go`` that phase 18
    writes once phase 17 and the launcher are done, so that they run on
    the card alone.  Whatever still runs at exit is killed."""
    import shutil
    import socket
    import tempfile
    tmp = tempfile.mkdtemp(prefix="ranks_")
    go = os.path.join(tmp, "go")
    groups = rank_groups(torch.cuda.device_count())
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    wall0, t0 = time.time(), time.perf_counter()
    procs = launchers({"ranks": [
        "torch.distributed.run", "--nproc-per-node", "2", "--master-addr",
        "127.0.0.1", "--master-port", port, "-m", *RANK_LAUNCH,
        "--log-every", "1", "--dist-backend", "gloo"]})
    ctx = spawn_ranks(groups, go, tmp)

    def stop():
        for p in procs.values():
            if p.poll() is None:
                p.kill()
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
        shutil.rmtree(tmp, ignore_errors=True)

    atexit.register(stop)
    return PendingRanks(ctx, procs, tmp, go, groups, wall0, t0)


def stage_ranks(torch, smi, pending: PendingRanks, held):
    """Phase 18: ``RANK_RUNS`` with one process a stage on the card
    (gloo, payloads staged through the host), held against phase 5; the
    launcher under ``torch.distributed.run`` (started with phase 17)
    against the one-process launcher, run here in process; the NCCL case
    where the machine has a card a rank.  ``held``: phase 5's runs.
    Returns the launches summed over the ranks."""
    import io
    import shutil
    from repro_torch.launch import train as launch_train
    t0 = time.perf_counter()
    ctx, procs, tmp, go, groups = pending[:5]
    cards = torch.cuda.device_count()
    try:
        with reaped([procs]):
            (rc_r, ranks, text), = launcher_results(procs, timeout=120
                                                    ).values()
        launcher_s = time.perf_counter() - pending.t0
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = launch_train.main([*RANK_LAUNCH[1:], "--log-every", "1"])
        one = [json.loads(ln) for ln in buf.getvalue().splitlines()
               if ln.startswith("{")]
        if rc != 0 or rc_r != 0:
            raise AssertionError(f"phase 18 launcher exited {rc_r} (one "
                                 f"process {rc}): {text[-3000:]}")
        open(go, "w").close()           # the ranks run from here, alone
        go_s = time.perf_counter() - t0
        recs = join_ranks(ctx, tmp, pending.wall0, t0 + 150, smi)
        check_rank_launcher(ranks, one, smi)
        launches = {k: 0 for k in KERNELS}
        for world, backend, names in groups:
            for r in recs[:world]:
                dev = [d for d in r["devices"] if d[0] == backend]
                if not dev or not dev[0][1].startswith("cuda") or \
                        dev[0][2] != (backend == "gloo"):
                    raise AssertionError(f"phase 18 {backend} rank: "
                                         f"{r['devices']}")
            for name in names:
                got = check_rank_run(name, recs[:world], held[name], smi,
                                     backend)
                for k in KERNELS:
                    launches[k] += got[k]
        hop = {c: {"send_ms": sum(recs[s]["hop_ms"][c]) / HOP_ITERS,
                   "recv_ms": sum(recs[d]["hop_ms"][c]) / HOP_ITERS}
               for c, s, d in (("q4", 0, 1), ("q8", 1, 0))}
        log("# ranks hop " + json.dumps({
            "card": smi, "backend": "gloo, staged through pinned host "
            "memory", "iters": HOP_ITERS,
            "fw_q4": {"bytes": PAYLOAD_BYTES["q4"], **hop["q4"]},
            "bw_q8_tiled": {"bytes": PAYLOAD_BYTES["q8_tiled"],
                            **hop["q8"]}}))
        if cards < 4:
            log(f"# ranks nccl: not run ({cards} card(s); NCCL takes one "
                f"card a rank; {smi})")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"# phase 18 launches {launches} (the launcher done "
        f"{launcher_s:.1f} s after its start with phase 17; the ranks "
        f"set going at {go_s:.1f} s; the phase {time.perf_counter() - t0:.1f}"
        f" s; {smi})")
    return launches


def main() -> int:
    # cuBLAS reads this when it starts, so it goes before any CUDA call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    torch.use_deterministic_algorithms(True)
    # the wrappers write every element they allocate; no NaN fill kernels
    torch.utils.deterministic.fill_uninitialized_memory = False
    from repro_torch import device as D
    from repro_torch.kernels import _build, framing, ops, pack4, quantize
    from repro_torch.kernels import tiling, topk_select as topk
    from repro_torch.transport import codecs, collectives
    dryrun = start_dryrun()             # phase 17 joins it; it needs no card

    # -- phase 1 ------------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    t0 = time.perf_counter()
    reports = _build.build()
    log(f"# built {sorted(reports)} in {time.perf_counter() - t0:.1f} s")
    for name, rep in reports.items():
        print(f"# ptxas {name}:\n{rep}", file=sys.stderr, flush=True)

    # -- phase 2 ------------------------------------------------------------
    inputs = kernel_inputs(torch)
    shapes, dtypes = gpt2_leaves(torch)
    timed = select_phase(torch, D, topk, inputs, shapes)
    torch.cuda.empty_cache()
    err = check_kernels(torch, D, pack4, inputs)
    cuts = cut_inputs(torch)
    err.update(check_cut_kernels(torch, D, ops, cuts))
    for label in (PREFILL, DECODE):
        timed[label].update(time_pack4(torch, D, pack4, inputs[label]))
        for name in ("pack4_wire", "unpack4_wire"):
            log(f"# {name} {label}: " + json.dumps(timed[label][name]))
    for label in (CUT, CUT32):
        timed[label] = time_cut_kernels(torch, D, ops, cuts[label])
        for name, row in timed[label].items():
            log(f"# {name} {label}: " + json.dumps(row))
    err.update(check_wire_kernels(torch, D, quantize, framing, codecs,
                                  tiling))
    wire = time_wire_kernels(torch, D, quantize, framing, codecs, tiling)
    for label, rows in wire.items():
        timed.setdefault(label, {}).update(rows)
        for name, row in rows.items():
            log(f"# {name} {label}: " + json.dumps(row))
    err.update(check_dp_kernels(torch, D, codecs, collectives, framing,
                                shapes, dtypes))
    timed.update(time_dp_kernels(torch, D, codecs, collectives, framing,
                                 shapes, dtypes))
    for label in (DPQ8, DPQ4):
        log(f"# decode_sum_fused {label}: " + json.dumps(timed[label]))
    for label in (DPF8, DPF4, DPFT, DPFN):
        for name, row in timed[label].items():
            log(f"# {name} {label}: " + json.dumps(row))
    for label, rows in q4_phase(torch, D, pack4, shapes).items():
        timed.setdefault(label, {}).update(rows)
    cnn_err, cnn_timed = cnn_kernels(torch, D, ops, quantize, pack4, topk,
                                     framing, codecs, tiling)
    pd_err, pd_timed = pd_kernels(torch, D, pack4, topk, codecs,
                                  collectives, tiling)
    tp_err, tp_timed = tp_kernels(torch, D, quantize, pack4, topk, framing,
                                  codecs, collectives, tiling)
    cs_err, cs_timed = cs_kernels(torch, D, pack4, topk)
    big_err, big_timed = big_kernels(torch, D, ops, pack4)
    moe_err, moe_timed = big_kernels(torch, D, ops, pack4, MOE_CUTS, MOE_Q4)
    rec_err, rec_timed = big_kernels(torch, D, ops, pack4, REC_CUTS, REC_Q4)
    wh_err, wh_timed = whisper_kernels(torch, D, ops, pack4, topk, codecs,
                                       collectives, framing)
    err = {k: max(err.get(k, 0.0), cnn_err[k], pd_err[k], tp_err[k],
                  cs_err[k], big_err[k], moe_err[k], rec_err[k],
                  wh_err.get(k, 0.0))
           for k in KERNELS}
    timed.update(cnn_timed)
    timed.update(pd_timed)
    timed.update(tp_timed)
    timed.update(cs_timed)
    timed.update(big_timed)
    timed.update(moe_timed)
    timed.update(rec_timed)
    timed.update(wh_timed)
    torch.cuda.empty_cache()
    for label, rows in timed.items():
        for name, row in ({"decode_sum_fused": rows} if "ms" in rows
                          else rows).items():
            if "library_lost_ms" in row:
                log(f"# LOST library call of {name} {label}: its profiles "
                    f"recorded {row['library_device_ops']} device ops a "
                    f"call of the {row['library_launches']} it launches; "
                    "its time is not to be used")
            elif row["lost"]:
                log(f"# LOST {name} {label}: its profiles recorded "
                    f"{row['device_ops']} device ops a call, fewer than "
                    f"the launches; its times are not to be used")
    log(f"# phase 2 done at {time.perf_counter() - t0:.1f} s")

    # -- phases 3-18: each main path, its counts set to 0 just before it and
    # read just after (phase 18's in its ranks); the kernels line sums them
    paths, held = [], {}
    for phase, run in ((3, lambda: serve(torch, np, D, _build)),
                       (4, lambda: train(torch, D, _build)),
                       (5, lambda: pipeline(torch, D, _build, held)),
                       (6, lambda: data_parallel(torch, D, _build)),
                       (7, lambda: cnn(torch, D, _build)),
                       (8, lambda: pipeline_dp(torch, D, _build, smi)),
                       (9, lambda: train_state(torch, D, _build, smi)),
                       (10, lambda: tensor_axis(torch, D, _build, smi)),
                       (11, lambda: continuous(torch, np, D, _build, smi)),
                       (12, lambda: telemetry(torch, D, _build, smi)),
                       (13, lambda: big_models(torch, np, _build, smi)),
                       (14, lambda: moe_models(torch, np, _build, smi)),
                       (15, lambda: rec_models(torch, np, _build, smi)),
                       (16, lambda: whisper_models(torch, np, _build,
                                                   smi)),
                       (17, lambda: tooling(torch, _build, smi, dryrun)),
                       (18, lambda: stage_ranks(torch, smi, pending,
                                                held))):
        if phase == 17:
            # phase 18's launcher and ranks start beside phase 17: the
            # ranks import and wait, and run on the card after it
            pending = start_stage_ranks(torch)
        paths.append(run())
        log(f"# phase {phase} done at {time.perf_counter() - t0:.1f} s")
    launches = {k: sum(p[k] for p in paths) for k in KERNELS}
    for k, v in launches.items():
        if not v:
            raise AssertionError(f"{k} was launched on no main path")

    # -- phase 19: the kernels line -----------------------------------------
    line = []
    for name, (src, replaces) in KERNELS.items():
        row = (timed[DPQ8] if name in DP_KERNELS else
               timed[SEL_LEAF if name in SELECT_KERNELS else
                     CUT if name in TRAIN_KERNELS else
                     WIRE if name == "quantize_wire" else
                     FRAMED if name in WIRE_KERNELS else PREFILL][name])
        line.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": err[name], "ms": row["ms"],
                     "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                     "bound_by": row["bound_by"],
                     "library_ms": row["library_ms"]})
    log(json.dumps({"kernels": line}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
