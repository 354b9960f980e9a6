"""The readings that the check's limits are set from, for one cell, in one
process: for each seed, one call of the window's entry at the cell's own
size (its first call: eval seed ``traffic.eval_seed(seed, 0)``) judged as
a run judges it, and, in the program's place, the reference's
lower-precision control (``precision="control"``) and a planted fault
(each batch's loss over its first half, the mean taken over those rows).

    python3 benchmark/readings.py --workload <name> --seeds 1 2 3 --out F.jsonl

Writes one JSON line a seed: the program's, the control's and the
fault's numbers. The benchmark's own runs do not run this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [ROOT] + [p for p in sys.path
                            if os.path.abspath(p or ".") != here]
    from benchmark import cell

    spec = cell.resolve(args.workload)
    with open(args.out, "a") as f:
        for seed in args.seeds:
            t0 = time.perf_counter()
            row = read_seed(spec, seed, args.device)
            row["seconds"] = time.perf_counter() - t0
            f.write(json.dumps(row) + "\n")
            f.flush()
            print(json.dumps(row), flush=True)
    return 0


def read_seed(spec, seed: int, device) -> dict:
    import torch

    from benchmark import cell, check, data, traffic
    from cmoop_audio_processing_torch.engine.evaluator import \
        PopulationEvaluator
    from cmoop_audio_processing_torch.engine.trainer import PopulationTrainer

    config = spec["config"]
    genomes = traffic.genomes(spec["traffic"])
    cfg = cell.program_config(config, spec["traffic"])
    d = data.cell_data(config, seed)
    evaluator = PopulationEvaluator(d, cfg, device=device)
    es = traffic.eval_seed(seed, 0)
    with check.Recorder(PopulationTrainer) as rec:
        rec.record_steps = rec.keep_final = True
        t0 = time.perf_counter()
        ans = evaluator.evaluate(genomes, seed=es)
        call_s = time.perf_counter() - t0
        del evaluator
        reference = check.Reference(config, d, device)
        judged = check.judge(reference, genomes, rec, ans, es,
                             config["train"]["restore_best_weights"], [ans])
        restore = config["train"]["restore_best_weights"]
        by_uid = {check.frozen.genome_uid(g): g for g in genomes}
        control, fault, control_detail, half_detail = [], [], [], []
        for g in genomes:
            refd, _ = reference.steps(g, es)
            ctl, _ = reference.steps(g, es, precision="control")
            half, _ = reference.steps(g, es, half_batch=True)
            control.append(check.step_numbers(ctl, refd))
            control_detail.append({k: ctl[k] for k in
                                   ("loss", "grad", "change", "bn")})
            fault.append(check.step_numbers(half, refd))
            half_detail.append({k: half[k] for k in
                                ("loss", "grad", "change", "bn")})
        for fin in rec.finals:
            params = fin["best_params"] if restore else fin["params"]
            state = fin["best_state"] if restore else fin["state"]
            for p, uid in enumerate(fin["uids"]):
                g = by_uid[uid]
                lp, ls = check._lane(params, p), check._lane(state, p)
                r = reference.validate(g, lp, ls)
                c = reference.validate(g, lp, ls, precision="control")
                control.append(check.val_numbers(c, r))
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return {"workload": spec["name"], "seed": seed, "eval_seed": es,
            "call_s": call_s, "program": judged["numbers"],
            "notes": judged["notes"], "control": check.worst(control),
            "half_batch": check.worst(fault), "detail": judged["detail"],
            "control_detail": control_detail, "half_detail": half_detail}


if __name__ == "__main__":
    sys.exit(main())
