"""Training launcher: the LM run (port of ``repro/launch/train.py``).

Trains a registry architecture (full width, or ``--smoke``) on the
synthetic order-2 Markov token stream with a boundary-compression policy
at every stage cut, printing one JSON metrics line per log interval.
Runs on ``cuda`` unless ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-small \\
      --steps 20 --batch 8 --seq 128 --policy q4q8
  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-small \\
      --smoke --device cpu --steps 4 --policy top10 --feedback aqsgd
  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-small \\
      --smoke --device cpu --transport pipeline --stages 2 \\
      --schedule 1f1b --pipeline-microbatches 2 --policy q4q8
  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-small \\
      --smoke --device cpu --mesh data=2 --wire data=q4+ef --policy q4q8
  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-small \\
      --mesh data=2,stage=4 --wire data=q8 --policy q4q8 --batch 32 \\
      --pipeline-microbatches 4
  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-small \\
      --smoke --device cpu --mesh tensor=2 --wire tensor=q8+ef
  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-small \\
      --smoke --device cpu --mesh data=2,stage=2,tensor=2 \\
      --wire data=q8,stage=q8,tensor=q4 --batch 8 --seq 32 \\
      --pipeline-microbatches 2
  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-small \\
      --smoke --device cpu --grad-accum 2 --policy q4q8
  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-small \\
      --smoke --device cpu --steps 4 --policy 'topk:0.1@depth<1;q4@dir=bw;q8'
  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-small \\
      --smoke --device cpu --steps 2 --feedback aqsgd --ckpt /tmp/s.npz
  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-small \\
      --smoke --device cpu --steps 4 --feedback aqsgd --resume /tmp/s.npz
  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-small \\
      --smoke --device cpu --steps 4 --feedback aqsgd --metrics 2 \\
      --trace /tmp/t.jsonl --perfetto /tmp/t.json

``--transport simulated`` compresses simulated stage cuts;
``--transport pipeline`` runs the layer stack through the real
compressed pipeline (``--stages``, ``--schedule``, ``--virtual-stages``,
``--pipeline-microbatches``; one process, every stage on the one
device), and its JSON lines add the step's forward and backward wire
bytes.  ``--mesh data=N --wire data=codec[+feedback][:k]`` (or the
deprecated ``--dp`` / ``--dp-codec`` / ``--dp-feedback`` /
``--dp-k-frac``) adds N data-parallel replicas with the compressed
gradient all-reduce: lanes around the simulated cuts, or, with
``stage=S`` too (or ``--transport pipeline``), N pipelines of S stages
whose layer-stack gradients cross the reduce in S stage columns; the
JSON lines add the ring's ``dp_bytes`` per step.  ``tensor=T`` (with
``--wire tensor=codec[+ef|+ef21][:k]``) runs the layer stack over a
tensor ring of T ranks with the compressed all-gather / reduce-scatter,
alone, with the data lanes, or inside every pipeline stage (there with a
feedback-free tensor wire); the JSON lines add ``tp_bytes`` per step.
The tensor wire's feedback buffers are not saved: ``--resume`` restarts
them from zero, as the reference does.  ``--grad-accum K``
(deprecated alias ``--microbatches``) splits each step's batch into K
pieces on the simulated transport.  ``--policy`` takes a named policy
or a rule spec (``'q4@size>=65536;q8@size>=16384;none'``, first match
wins per cut, resolved against ``seq * d_model``), and a ``--wire`` axis
codec a quoted rule spec (``data=q4@size>=100000000;q8``, resolved
against the parameter count for the data axis).  ``--ckpt PATH`` saves
the whole train state (params, AdamW moments, the cuts' and the DP
reduce's feedback buffers) every ``--save-every`` steps and at the end
(``{step}`` in PATH keeps one file a save); ``--resume PATH`` restores it
and restarts the token stream at the saved step, so that the resumed run
is the uninterrupted one bit for bit.  ``--trace PATH`` turns tracing on
and writes the JSONL event log there (``obs/export.py``'s schema),
``--perfetto PATH`` a Chrome-trace file, and ``--metrics N`` (which turns
tracing on too) runs the quality tap every N steps: each boundary's
codec round-trip error on a seeded sample and the feedback buffers'
norms (``obs/quality.py``).  Every step then runs in a ``train.step``
span that holds its synced loss.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
import warnings

import numpy as np
import torch

from repro_torch.checkpoint import io as ckpt_io
from repro_torch.configs.registry import ARCHS, get
from repro_torch.core.boundary import init_boundary_state
from repro_torch.core.parallel import spec_from_cli
from repro_torch.core.policy import (POLICIES, CompressionPolicy,
                                     aqsgd_policy, ef_policy,
                                     parse_policy_rules, resolve_policy)
from repro_torch.device import resolve_device
from repro_torch.models import encdec, transformer
from repro_torch.models.config import param_count
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.export import to_chrome_trace, to_jsonl
from repro_torch.obs.quality import QualityTap
from repro_torch.optim.optimizers import OptimizerConfig, init_opt_state
from repro_torch.train.loop import _pipeline_bstates, init_lm_dp_state
from repro_torch.train.steps import _resolve_parallel, make_lm_train_step
from repro_torch.transport.schedules import get_schedule
from repro_torch.transport.tp_collectives import init_tp_state


def synthetic_stream(cfg, batch: int, seq: int, seed: int = 0,
                     num_samples: int = 4096, start_step: int = 0,
                     dp: int = 1):
    """Deterministic order-2 Markov token stream, vocab-clipped to the
    model's vocabulary; bitwise the reference's (numpy ``RandomState``).
    Each step's batch is a pure function of (seed, step).  Ids cycle over
    ``num_samples`` so that AQ-SGD's per-example buffers revisit rows.

    ``dp > 1`` deals ids per replica: contiguous batch shard r cycles over
    its own id block ``[r*num_samples/dp, (r+1)*num_samples/dp)``, the
    AQ-SGD + DP routing contract (``core/feedback.shard_ids``)."""
    rng = np.random.RandomState(seed)
    vocab = min(cfg.vocab_size, 1024)
    succ = rng.randint(0, vocab, size=(vocab, vocab, 4))
    step = start_step
    while True:
        r = np.random.RandomState(seed + 1 + step)
        out = np.zeros((batch, seq), np.int32)
        out[:, 0] = r.randint(0, vocab, batch)
        out[:, 1] = r.randint(0, vocab, batch)
        for t in range(2, seq):
            out[:, t] = succ[out[:, t - 2], out[:, t - 1],
                             r.randint(0, 4, batch)]
        if dp > 1:
            sh, per = batch // dp, num_samples // dp
            ids = np.concatenate(
                [r * per + (np.arange(sh, dtype=np.int32) + sh * step) % per
                 for r in range(dp)])
        else:
            ids = (np.arange(batch, dtype=np.int32)
                   + batch * step) % num_samples
        yield out, ids
        step += 1


def make_batch(cfg, tokens, device) -> dict:
    """A train step's batch from (n, S) numpy tokens, on ``device``: the
    tokens, and the reference's stub inputs: zero (n, num_patches,
    d_model) bf16 patch embeddings for the vision frontend, zero (n,
    enc_seq, d_model) bf16 frame embeddings for the encoder-decoder."""
    b = {"tokens": torch.from_numpy(tokens).to(device, torch.int64)}
    if cfg.frontend == "vision":
        b["patch_embeds"] = torch.zeros(
            (tokens.shape[0], cfg.num_patches, cfg.d_model),
            dtype=torch.bfloat16, device=device)
    if cfg.enc_dec:
        b["enc_embeds"] = torch.zeros(
            (tokens.shape[0], cfg.enc_seq, cfg.d_model),
            dtype=torch.bfloat16, device=device)
    return b


def build_policy(name: str, feedback: str = "none", k_frac: float = 0.1):
    """The named policy, or the unresolved ``PolicyRules`` of a rule spec
    (a bad one raises ``ValueError``); ``feedback`` replaces every cut
    with TopK(k_frac) under that compensation, as the reference's
    ``--feedback`` does."""
    policy = (POLICIES[name]() if name in POLICIES
              else parse_policy_rules(name))
    if feedback != "none":
        bp = (aqsgd_policy(k_frac) if feedback == "aqsgd"
              else ef_policy(k_frac, feedback))
        stages = policy.num_stages if policy.num_boundaries else 4
        policy = CompressionPolicy(num_stages=stages, boundary=bp)
    return policy


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt2-small", choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--policy", default="none",
                    help="a named policy (%s) OR an adaptive rule spec: "
                         "';'-separated 'codec[:k_frac][@cond,...]' rules, "
                         "conds size>=N | size<N | depth>=N | depth<N | "
                         "bandwidth>=X | bandwidth<X (fires only under a "
                         "probe: run_lm_experiment's bandwidth_probe) | "
                         "dir=fw|bw — first "
                         "match wins per cut, e.g. "
                         "'q4@size>=65536;q8@size>=16384;none' (resolved "
                         "against seq*d_model)"
                         % ", ".join(sorted(POLICIES)))
    ap.add_argument("--transport", default="simulated",
                    choices=("simulated", "pipeline"),
                    help="simulated boundary (paper) or the real "
                         "compressed pipeline")
    ap.add_argument("--stages", type=int, default=None,
                    help="pipeline stage count (default: policy's)")
    ap.add_argument("--schedule", default="gpipe",
                    choices=("gpipe", "1f1b", "interleaved"),
                    help="pipeline schedule: gpipe (minimum-tick skew), "
                         "1f1b (rematerialized stages + fused single-buffer "
                         "hops), interleaved (--virtual-stages slices per "
                         "device: 1/v the bubble, v*S-1 compressed cuts)")
    ap.add_argument("--virtual-stages", type=int, default=None,
                    help="virtual stage slices per device for --schedule "
                         "interleaved (default 2)")
    ap.add_argument("--pipeline-microbatches", type=int, default=None,
                    help="microbatch count for the pipeline transport "
                         "(default: the stage count)")
    ap.add_argument("--mesh", default=None, metavar="SPEC",
                    help="mesh sizes, 'data=2' (axis aliases dp/pp/tp/model "
                         "accepted; missing axes default to 1).  stage>1 "
                         "implies --transport pipeline, and data>1 with "
                         "stage>1 runs the 2D (data, stage) grid; tensor>1 "
                         "shards the layer stack over a compressed tensor "
                         "ring (alone, with data, or in every stage: "
                         "data=2,stage=2,tensor=2).  Replaces --dp/--stages")
    ap.add_argument("--wire", default=None, metavar="SPEC",
                    help="per-axis wire config "
                         "'axis=codec[+feedback][:k_frac]', e.g. "
                         "'data=q8+ef:0.1'.  Codecs none|q8|q4|topk (or a "
                         "quoted rule spec); feedback ef|ef21 (the tensor "
                         "wire: feedback-free inside a pipeline).  Replaces "
                         "--dp-codec/"
                         "--dp-feedback/--dp-k-frac")
    ap.add_argument("--dp", type=int, default=1,
                    help="DEPRECATED (use --mesh data=N): data-parallel "
                         "replicas: the global batch splits into --dp "
                         "contiguous shards whose gradients are all-reduced "
                         "over the compressed wire "
                         "(transport/collectives.py)")
    ap.add_argument("--dp-codec", default="none",
                    choices=("none", "q8", "q4", "topk"),
                    help="DEPRECATED (use --wire data=CODEC): wire codec "
                         "of the DP gradient all-reduce")
    ap.add_argument("--dp-feedback", default="none",
                    choices=("none", "ef", "ef21"),
                    help="DEPRECATED (use --wire data=codec+FEEDBACK): "
                         "per-replica error feedback on the DP reduce")
    ap.add_argument("--dp-k-frac", type=float, default=0.1,
                    help="DEPRECATED (use --wire data=topk:K): TopK kept "
                         "fraction for --dp-codec topk")
    ap.add_argument("--feedback", default="none",
                    choices=("none", "ef", "ef21", "efmixed", "aqsgd"),
                    help="error-feedback mode (paper Tables 3-4); replaces "
                         "the boundary with TopK(--k-frac) + this "
                         "compensation")
    ap.add_argument("--k-frac", type=float, default=0.1)
    ap.add_argument("--num-samples", type=int, default=4096,
                    help="AQ-SGD per-example buffer size; the stream's ids "
                         "cycle modulo this")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="gradient-accumulation splits of the global batch "
                         "(bounds activation memory at B/grad_accum)")
    ap.add_argument("--microbatches", type=int, default=None,
                    help="DEPRECATED alias for --grad-accum (and, with "
                         "--transport pipeline, for "
                         "--pipeline-microbatches)")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint path (npz); saves the FULL train "
                         "state: params + optimizer moments + feedback "
                         "buffers (checkpoint/io.save_train_state).  A "
                         "'{step}' placeholder keeps one file per save "
                         "instead of overwriting")
    ap.add_argument("--save-every", type=int, default=None,
                    help="checkpoint every N steps (default 100)")
    ap.add_argument("--ckpt-every", type=int, default=None,
                    help="DEPRECATED alias for --save-every")
    ap.add_argument("--resume", default=None,
                    help="resume from a --ckpt train-state file: restores "
                         "params, optimizer state, feedback buffers, and "
                         "the data-stream position")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=None, help="write metrics here")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="enable telemetry and write the JSONL event log "
                         "here (obs/export.py schema; default: tracing "
                         "off, zero overhead)")
    ap.add_argument("--perfetto", default=None, metavar="PATH",
                    help="also write a Chrome-trace JSON loadable at "
                         "ui.perfetto.dev / chrome://tracing")
    ap.add_argument("--metrics", type=int, default=0, metavar="N",
                    help="sample per-boundary compression error + "
                         "feedback-buffer norms every N steps (obs/"
                         "quality.py; 0 = off; implies tracing)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    tracing = bool(args.trace or args.perfetto or args.metrics)
    if not tracing:
        return _train(ap, args, False)
    obs_trace.enable()
    try:
        return _train(ap, args, True)
    finally:
        obs_trace.disable()


def _train(ap, args, tracing: bool) -> int:
    """:func:`main` after the parse; ``tracing``: the tracer is on."""
    grad_accum = args.grad_accum
    pipeline_mb = args.pipeline_microbatches
    if args.microbatches is not None:
        if args.transport == "pipeline":
            if pipeline_mb is not None:
                ap.error("--microbatches (deprecated) conflicts with "
                         "--pipeline-microbatches — drop --microbatches")
            warnings.warn("--microbatches is deprecated: use "
                          "--pipeline-microbatches for the pipeline "
                          "microbatch count", DeprecationWarning)
            if args.microbatches > 1:
                pipeline_mb = args.microbatches
        else:
            if grad_accum != 1:
                ap.error("--microbatches (deprecated) conflicts with "
                         "--grad-accum — drop --microbatches")
            warnings.warn("--microbatches is deprecated: use --grad-accum "
                          "for gradient accumulation", DeprecationWarning)
            grad_accum = args.microbatches
    save_every = args.save_every
    if args.ckpt_every is not None:
        if save_every is not None:
            ap.error("--ckpt-every (deprecated) conflicts with "
                     "--save-every — drop --ckpt-every")
        warnings.warn("--ckpt-every is deprecated: use --save-every",
                      DeprecationWarning)
        save_every = args.ckpt_every
    save_every = 100 if save_every is None else save_every

    cfg = get(args.arch, smoke=args.smoke)
    try:
        transformer.check_supported(cfg)
    except NotImplementedError as e:
        ap.error(str(e))
    dev = resolve_device(args.device)
    seq = min(args.seq, cfg.max_seq)
    try:
        policy = build_policy(args.policy, args.feedback, args.k_frac)
    except ValueError as e:
        ap.error(f"--policy {args.policy!r} is neither a named policy "
                 f"({', '.join(sorted(POLICIES))}) nor a valid rule "
                 f"spec: {e}")
    if args.stages:
        policy = dataclasses.replace(policy, num_stages=args.stages)
    # rules -> concrete per-cut codecs, keyed by the LM's uniform cut size
    policy = resolve_policy(policy, seq * cfg.d_model)
    virtual_stages = (args.virtual_stages if args.virtual_stages is not None
                      else (2 if args.schedule == "interleaved" else 1))
    parallel = None
    if args.mesh or args.wire:
        legacy_used = [f for f, used in
                       (("--dp", args.dp != 1),
                        ("--dp-codec", args.dp_codec != "none"),
                        ("--dp-feedback", args.dp_feedback != "none"),
                        ("--dp-k-frac", args.dp_k_frac != 0.1),
                        ("--stages", bool(args.stages))) if used]
        if legacy_used:
            ap.error(f"--mesh/--wire conflict with the deprecated "
                     f"{', '.join(legacy_used)} — configure every axis "
                     "through --mesh/--wire")
        try:
            # rule-coded axis wires resolve statically: data carries the
            # gradient tree, stage the per-example cut, tensor its 1/tp
            # sequence shard
            parallel = spec_from_cli(args.mesh, args.wire)
            parallel = parallel.resolved(
                {"data": param_count(cfg), "stage": seq * cfg.d_model,
                 "tensor": seq * cfg.d_model // max(parallel.tp, 1)})
            _, policy_eff, transport = _resolve_parallel(
                "launch.train", parallel, policy, args.transport, {})
        except (ValueError, NotImplementedError) as e:
            ap.error(f"--mesh/--wire: {e}")
        dp_n, dp_codec, dp_feedback = (parallel.dp, parallel.data.codec,
                                       parallel.data.feedback)
        tp_n = parallel.tp
    else:
        policy_eff, transport = policy, args.transport
        dp_n, dp_codec, dp_feedback = args.dp, args.dp_codec, args.dp_feedback
        tp_n = 1
    pipeline = transport == "pipeline"
    if args.batch % (dp_n * grad_accum):
        ap.error(f"--batch {args.batch} is not divisible by the {dp_n} "
                 f"data-parallel replicas x {grad_accum} accumulation "
                 "pieces")
    print(f"# arch={cfg.arch_id} B={args.batch} S={seq} "
          f"policy={args.policy}"
          f"{'' if args.feedback == 'none' else '+' + args.feedback} "
          f"device={dev}", flush=True)

    opt = OptimizerConfig(kind="adamw", lr=args.lr, weight_decay=0.01,
                          schedule="cosine", t_max=args.steps, grad_clip=1.0)
    params = (encdec if cfg.enc_dec else transformer).init_params(
        torch.Generator(device=dev).manual_seed(args.seed), cfg)
    opt_state = init_opt_state(opt, params)
    if pipeline:
        if cfg.enc_dec:
            ap.error("pipeline transport: decoder-only archs")
        sched = get_schedule(args.schedule, virtual_stages)
        mb_eff = pipeline_mb or policy_eff.num_stages
        if args.batch % (mb_eff * dp_n):
            ap.error(f"--batch {args.batch} is not divisible by the "
                     f"{mb_eff} pipeline microbatches x {dp_n} replicas")
        try:
            sched.validate(mb_eff, policy_eff.num_stages)
            transformer.stack_layer_stages(
                params, policy_eff.num_stages * virtual_stages)
            bstates = _pipeline_bstates(
                policy_eff, (seq, cfg.d_model), batch=args.batch,
                microbatches=pipeline_mb, num_samples=args.num_samples,
                dtype=torch.bfloat16, virtual_stages=virtual_stages,
                dp=dp_n, device=dev)
        except ValueError as e:
            ap.error(str(e))
        print(f"# pipeline transport: schedule={args.schedule} "
              f"microbatches={mb_eff} "
              f"{sched.describe(mb_eff, policy_eff.num_stages)}", flush=True)
    else:
        # the cuts that exist: segment_bounds caps the stages at the
        # groups (the decoder's layers for an encoder-decoder)
        units = cfg.num_layers if cfg.enc_dec else cfg.num_groups
        cuts = len(transformer.segment_bounds(units,
                                              policy_eff.num_stages)) - 1
        bstates = [init_boundary_state(policy_eff.at(i), (seq, cfg.d_model),
                                       batch=args.batch,
                                       num_samples=args.num_samples,
                                       dtype=torch.bfloat16, device=dev)
                   for i in range(cuts)]
    if parallel is not None:
        pkw = {"parallel": parallel}
    else:
        # only the legacy kwargs the user set, so that a plain run never
        # warns ParallelDeprecationWarning
        pkw = {k: v for k, v, d in (("dp", args.dp, 1),
                                     ("dp_codec", args.dp_codec, "none"),
                                     ("dp_feedback", args.dp_feedback,
                                      "none"),
                                     ("dp_k_frac", args.dp_k_frac, 0.1))
               if v != d}
    try:
        step_fn = make_lm_train_step(
            cfg, policy, opt, remat=not args.no_remat,
            grad_accum=grad_accum, transport=args.transport,
            pipeline_microbatches=pipeline_mb,
            schedule=args.schedule, virtual_stages=virtual_stages, **pkw)
    except (ValueError, NotImplementedError) as e:
        ap.error(str(e))
    dp_state = None
    if dp_n > 1:
        dp_state = init_lm_dp_state(cfg, params, policy_eff, dp_n,
                                    dp_feedback, transport=transport,
                                    virtual_stages=virtual_stages, tp=tp_n)
        print(f"# dp={dp_n} gradient all-reduce: codec={dp_codec} "
              f"feedback={dp_feedback}", flush=True)
    tp_state = None
    if tp_n > 1:
        t_ax = parallel.tensor
        print(f"# tp={tp_n} tensor collectives: codec={t_ax.codec} "
              f"feedback={t_ax.feedback}", flush=True)
        if not pipeline:
            tp_state = init_tp_state((args.batch, seq, cfg.d_model),
                                     transformer.tp_sites(cfg),
                                     t_ax.feedback, device=dev)
    start_step = 0
    if args.resume:
        if dp_n > 1:
            params, opt_state, bstates, dp_state, start_step = \
                ckpt_io.restore_train_state(args.resume, params, opt_state,
                                            bstates, dp_like=dp_state)
        else:
            params, opt_state, bstates, start_step = \
                ckpt_io.restore_train_state(args.resume, params, opt_state,
                                            bstates)
        print(f"# resumed step-{start_step} train state from {args.resume}",
              flush=True)
        if tp_state is not None and parallel.tensor.feedback != "none":
            print("# note: tensor-wire feedback residuals are not "
                  "checkpointed — resuming with zeroed tp_state", flush=True)
    stream = synthetic_stream(cfg, args.batch, seq, args.seed,
                              num_samples=args.num_samples,
                              start_step=start_step, dp=dp_n)
    tap = (QualityTap((args.batch, seq, cfg.d_model), every=args.metrics,
                      dtype=torch.bfloat16, seed=args.seed, device=dev)
           if args.metrics else None)
    metrics, t0 = [], time.time()
    for step in range(start_step + 1, args.steps + 1):
        toks, ids = next(stream)
        with obs_trace.span("train.step", cat="train", step=step) as sa:
            extra = [s for s in (dp_state, tp_state) if s is not None]
            out = step_fn(params, opt_state, bstates,
                          make_batch(cfg, toks, dev),
                          torch.from_numpy(ids).to(dev), *extra)
            params, opt_state, bstates, m = out[0], out[1], out[2], out[-1]
            rest = list(out[3:-1])
            if dp_state is not None:
                dp_state = rest.pop(0)
            if tp_state is not None:
                tp_state = rest.pop(0)
            if tracing:
                sa["loss"] = round(float(m["loss"]), 6)  # sync in span
        if tap is not None:
            tap.maybe_sample(step, policy, bstates or None)
        if step % args.log_every == 0 or step == args.steps:
            loss = float(m["loss"])       # waits for the device
            dt = time.time() - t0
            rec = {"step": step, "loss": round(loss, 4),
                   "ppl": round(math.exp(min(loss, 20.0)), 2),
                   "tok_per_s": round((step - start_step) * args.batch
                                      * seq / dt, 1),
                   "wall_s": round(dt, 1)}
            if pipeline:
                rec.update(fw_bytes=m["wire"]["fw_bytes"],
                           bw_bytes=m["wire"]["bw_bytes"])
            if dp_state is not None:
                rec["dp_bytes"] = m["wire"]["dp_bytes"]
            if tp_n > 1:
                rec["tp_bytes"] = m["wire"]["tp_bytes"]
            metrics.append(rec)
            print(json.dumps(rec), flush=True)
        if args.ckpt and (step % save_every == 0 or step == args.steps):
            ckpt_io.save_train_state(
                args.ckpt.replace("{step}", str(step)), params, opt_state,
                bstates, step=step,
                extra={"arch": cfg.arch_id, "policy": args.policy,
                       "feedback": args.feedback, "dp": dp_n,
                       "dp_codec": dp_codec, "tp": tp_n},
                dp_state=dp_state)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(metrics, f, indent=1)
    if tracing:
        tr = obs_trace.get_tracer()
        events = tr.drain()
        if args.trace:
            print(f"# trace: {to_jsonl(events, args.trace)} events "
                  f"-> {args.trace} (dropped {tr.dropped})", flush=True)
        if args.perfetto:
            print(f"# perfetto: {to_chrome_trace(events, args.perfetto)} "
                  f"events -> {args.perfetto}", flush=True)
    print("# done: final loss "
          f"{metrics[-1]['loss'] if metrics else 'n/a (already at --steps)'}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
