"""The readings that the limits of ``limits/<cell>.json`` are set from.

    python -m h100_bench.calibrate --workload <cell> --seeds a,b,...
        [--seconds 3] [--control_seeds x,y,z]

On the card, in one process (so the set-up of imports and the kernel's
build is paid once):

  * the program's readings: a short run of the cell's loop for each seed of
    ``--seeds`` (the cell's own sizes and load), and its numbers compared;
  * the control's, for each seed of ``--control_seeds``: the plain
    reference computed in the nearest precision below the one the
    configuration states, put in the program's place and judged as the
    program is (scoring at ``bf16``: fp8 e4m3 with a per-tensor scale at
    every conv's input, weight and output, where ``bf16`` rounds; training
    at ``highest``: TF32 in cuBLAS and cuDNN);
  * for a scoring cell, the planted fault of a decode that answers each
    site's best pair but one, with its own probability (the fp32 reference
    in the program's place);
  * for a training cell, the planted fault of a step that leaves half of
    each batch out (the reference, put in the program's place, taking the
    mean over the rest); a step that returns its state unchanged reads 1 in
    ``change_gap`` by its measure and needs no run.

Prints one JSON line per reading, then a summary line: each number's
largest program reading and smallest control and fault readings.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile

from . import cells, generator, weights
from .reference import model as ref
from .trace import Spans


def fp8(x):
    """x rounded to fp8 e4m3 under a per-tensor scale (its largest
    magnitude to 448), as float32."""
    import torch

    amax = x.detach().abs().max().clamp(min=1e-30)
    scale = 448.0 / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


def control_score(spec, seed, device, fault=None):
    """The scoring control on the pool sample a run checks: the fp8
    reference's answers judged against the fp32 reference's, as a run
    judges the port's.  ``fault="second"`` puts in the program's place the
    fp32 reference answering each site's best pair but one, with that
    pair's own probability (a decode that picks a wrong pair)."""
    import torch

    from .loops import score

    cfg, traffic = spec["config"], spec["traffic"]
    ranges = generator.read_ranges(cfg, traffic)
    net = ref.config(cfg["model"])
    params = weights.make_state_dict(ref.param_shapes(net), seed, device)
    rng = generator.rng_for(seed, 0, stream=7)
    sample = rng.choice(traffic["pool_batches"],
                        size=min(score.CHECK_BATCHES, traffic["pool_batches"]),
                        replace=False).tolist()
    per_site, per_site_bf16 = [], []
    for k in sorted(sample):
        batch = generator.make_batch(seed, k, traffic["sites_per_batch"],
                                     traffic["alleles_per_site"], ranges)
        terms = score.reference_answers(net, params, batch, device)
        S = batch["num_sites"]
        if fault == "second":
            _, site_l0, d, meta, site = terms
            answers = score.best_answers(
                site_l0, d, meta, site, S,
                skip=score.best_answers(site_l0, d, meta, site, S))
        else:
            answers = score.bf16_answers(net, params, batch, device,
                                         quant=fp8)
        per_site.append(score.gaps(answers, *terms, S))
        per_site_bf16.append(score.gaps(
            score.bf16_answers(net, params, batch, device), *terms, S))
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return score.readings_of(per_site, per_site_bf16)


def control_train(spec, seed, device, **fault):
    """The training control (TF32 on) or a planted fault, against the fp32
    reference."""
    from .loops import train

    cfg, traffic = spec["config"], spec["traffic"]
    ranges = generator.read_ranges(cfg, traffic)
    prims = [generator.make_batch(seed, k, traffic["sites_per_batch"],
                                  traffic["alleles_per_site"], ranges,
                                  labels=True)
             for k in range(train.CHECKED_STEPS)]
    refr = train.reference_steps(cfg, traffic, prims, seed, device)
    other = train.reference_steps(cfg, traffic, prims, seed, device,
                                  **(fault or {"tf32": True}))
    return train.gaps(other, refr), other, refr


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m h100_bench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control_seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("calibrate reads the card's numbers: no CUDA device\n")
        return 2
    device = torch.device("cuda", 0)
    spec = cells.cell(args.workload)
    loop = cells.loop(spec["traffic"]["loop"])
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control_seeds = [int(s) for s in args.control_seeds.split(",") if s]
    summary = {"program": {}, "control": {}, "fault_half": {},
               "fault_second": {}}

    def keep(side, readings):
        for k, v in readings.items():
            old = summary[side].get(k)
            summary[side][k] = v if old is None else (
                max(old, v) if side == "program" else min(old, v))

    for seed in seeds:
        with tempfile.TemporaryDirectory() as scratch:
            out = loop.run(spec, seed, args.seconds, False, device, Spans(),
                           scratch)
        line = {"side": "program", "seed": seed, **out["readings"],
                "attempted": out["attempted"]}
        if "sides" in out:
            prog, refr = out["sides"]
            line.update(losses=prog["losses"], ref_losses=refr["losses"])
        print(json.dumps(line), flush=True)
        keep("program", out["readings"])
    for seed in control_seeds:
        if spec["traffic"]["loop"] == "score":
            for side, fault in (("control", None),
                                ("fault_second", "second")):
                readings = control_score(spec, seed, device, fault=fault)
                print(json.dumps({"side": side, "seed": seed, **readings}),
                      flush=True)
                keep(side, readings)
            continue
        readings, other, refr = control_train(spec, seed, device)
        print(json.dumps({"side": "control", "seed": seed, **readings,
                          "losses": other["losses"],
                          "ref_losses": refr["losses"]}), flush=True)
        keep("control", readings)
        readings, other, _ = control_train(spec, seed, device, half=True)
        print(json.dumps({"side": "fault_half", "seed": seed, **readings,
                          "losses": other["losses"]}), flush=True)
        keep("fault_half", readings)
    print(json.dumps({"summary": args.workload, **summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
