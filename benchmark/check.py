"""What decides ``correct``: the timed path's own outputs against the plain
reference (``benchmark/reference``).

``Recorder`` watches the population trainer that ``PopulationEvaluator.
evaluate`` drives, at three public methods of ``engine/trainer.
PopulationTrainer``, and changes nothing it computes:

* ``batch_step`` and ``forward``: in the window's first call, the first
  ``STEPS`` optimizer steps of every launch: each step's logits, the
  per-leaf norms of the first gradient as Adam got it (its first moment
  after one step, over 1 - b1), and, after the last of them, the per-leaf
  norms of the parameters' and the BN state's change. Norms are taken on
  the device as the steps run and held as small tensors, so nothing of
  the population's size is kept alive;
* ``finalize``: the trained parameters and BN state that each launch's
  final validation reads, and its outputs, kept for the last call only.

After the window the reference follows the same steps from its own init,
in float32, one genome at a time, and validates each genome of the last
call on the program's trained state. Everything it knows of the
architecture (the frozen genome-keyed init, the plain forward pass) comes
from the module that the configuration's ``"reference"`` key names
(``benchmark/reference/<module>.py``); the shuffle and the dropout stream
from ``frozen``; loss, Adam, the step loop and validation from
``reference/training``. ``numbers`` turns the two sides into the numbers
that ``limits/<cell>.json`` bounds.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional

import numpy as np
import torch

from . import frozen, reference
from .reference import training

STEPS = 3
ADAM_B1 = 0.9
# A leaf whose reference gradient is below this share of the median
# leaf's moves under Adam by round-off alone (a conv bias ahead of BN):
# left out of the change.
STILL_LEAF = 1e-3

# Every number a run reads. A cell's ``limits/<cell>.json`` bounds those
# that decide its ``correct``; the others are printed beside them.
NAMES = ("logit_gap", "loss_gap", "loss_gap_all_steps", "grad_gap",
         "grad_gap_worst_leaf", "change_gap", "bn_gap", "val_loss_gap",
         "val_acc_gap", "val_fpr_gap", "size_gap")


def _paths(tree: Dict, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _lane_norms(tree: Dict, scale: float = 1.0, base: Optional[Dict] = None):
    """{path: (P,) norms over each lane} of a stacked tree, of ``tree -
    base`` when given; on the tree's device, not read back."""
    base_leaves = dict(_paths(base)) if base is not None else {}
    out = {}
    for path, t in _paths(tree):
        d = t.detach().float()
        if path in base_leaves:
            d = d - base_leaves[path].detach().float()
        out[path] = torch.linalg.vector_norm(d.flatten(1), dim=1) * scale
    return out


def _lane(tree: Dict, p: int) -> Dict:
    if isinstance(tree, dict):
        return {k: _lane(v, p) for k, v in tree.items()}
    return tree[p].detach().float()


class Recorder:
    """Wraps ``PopulationTrainer``'s ``forward``, ``batch_step`` and
    ``finalize`` while installed (a context manager)."""

    def __init__(self, trainer_cls):
        self.cls = trainer_cls
        self.record_steps = False
        self.keep_final = False
        self.launches: List[Dict] = []
        self.finals: List[Dict] = []
        self._logits: Optional[list] = None
        self._orig = {}

    def __enter__(self):
        rec = self
        orig = {n: getattr(self.cls, n) for n in
                ("forward", "batch_step", "finalize")}
        self._orig = orig

        def forward(tr, *a, **kw):
            out = orig["forward"](tr, *a, **kw)
            if rec._logits is not None and kw.get("train"):
                lg = out[0]
                lg = torch.cat(lg, dim=1) if isinstance(lg, list) else lg
                rec._logits.append(lg.detach().float())
            return out

        def batch_step(tr, params, state, opt, flags, *rest):
            launch = getattr(tr, "_bench_launch", None)
            if not rec.record_steps or (launch is not None
                                        and launch["steps"] >= STEPS):
                return orig["batch_step"](tr, params, state, opt, flags,
                                          *rest)
            if launch is None:
                launch = {"steps": 0, "logits": [],
                          "uids": flags["uid"].detach().cpu().tolist(),
                          "init_params": params, "init_state": state}
                tr._bench_launch = launch
                rec.launches.append(launch)
            rec._logits = launch["logits"]
            try:
                out = orig["batch_step"](tr, params, state, opt, flags,
                                         *rest)
            finally:
                rec._logits = None
            launch["steps"] += 1
            new_params, new_state, new_opt = out
            if launch["steps"] == 1:
                launch["grad"] = _lane_norms(new_opt["mu"],
                                             1.0 / (1.0 - ADAM_B1))
            if launch["steps"] == STEPS:
                launch["change"] = _lane_norms(new_params,
                                               base=launch["init_params"])
                launch["bn"] = _lane_norms(new_state,
                                           base=launch["init_state"])
                del launch["init_params"], launch["init_state"]
            return out

        def finalize(tr, carry, val):
            out = orig["finalize"](tr, carry, val)
            if rec.keep_final:
                rec.finals.append({
                    "uids": carry["flags"]["uid"].detach().cpu().tolist(),
                    "params": carry["params"], "state": carry["state"],
                    "best_params": carry["best_params"],
                    "best_state": carry["best_state"],
                    "val_loss": out["val_loss"].detach().cpu().tolist()})
            return out

        self.cls.forward = forward
        self.cls.batch_step = batch_step
        self.cls.finalize = finalize
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(self.cls, name, fn)
        return False

    def launch_records(self) -> List[Dict]:
        """The step records with every tensor read back to the host."""
        out = []
        for launch in self.launches:
            out.append({
                "uids": launch["uids"], "steps": launch["steps"],
                "logits": [t.cpu() for t in launch["logits"]],
                **{k: {p: v.cpu() for p, v in launch.get(k, {}).items()}
                   for k in ("grad", "change", "bn")}})
        return out


# -- the reference's side -------------------------------------------------------

def batches(train, eval_seed: int, batch_size: int, steps: int, device):
    """The first ``steps`` batches of the first epoch of a call with
    ``eval_seed``: (x, y, w, dropout key) from the padded train split."""
    x, y, w = train
    epoch_key = frozen.fold_in(frozen.train_key_of(eval_seed), 0)
    perm = frozen.permutation(epoch_key, x.shape[0])
    out = []
    for s in range(steps):
        idx = perm[s * batch_size:(s + 1) * batch_size]
        out.append((torch.as_tensor(x[idx.numpy()], device=device),
                    torch.as_tensor(y[idx.numpy()], device=device),
                    torch.as_tensor(w[idx.numpy()], device=device),
                    frozen.fold_in(epoch_key, int(idx[0]))))
    return out


def side_record(records: List[Dict], init_params: Dict, init_state: Dict,
                bn_used: bool) -> Dict:
    """A reference run's steps (``reference.training.train_steps``) in the
    form the program's side takes: per-leaf norms keyed by path."""
    def norms(tree, base=None):
        b = dict(_paths(base)) if base is not None else {}
        return {p: float(torch.linalg.vector_norm(
            (t - b[p]) if p in b else t)) for p, t in _paths(tree)}

    last = records[-1]
    return {
        "logits": [r["logits"].cpu() for r in records],
        "loss": [r["loss"] for r in records],
        "grad": norms(records[0]["grads"]),
        "change": norms(last["params"], init_params),
        "bn": norms(last["state"], init_state) if bn_used else {},
    }


def program_lane(launch: Dict, p: int, y_w) -> Dict:
    """Lane ``p`` of a recorded launch, with each step's weighted loss
    computed from the program's logits."""
    losses = []
    for lg, (yb, wb) in zip(launch["logits"], y_w):
        lgp = lg[p].double()
        if lgp.shape[0] != yb.shape[0]:  # not the batch the step was given
            losses.append(float("inf"))
            continue
        losses.append(float(training.weighted_loss(lgp, yb.cpu(),
                                                   wb.cpu().double())))
    return {
        "logits": [lg[p] for lg in launch["logits"]],
        "loss": losses,
        "grad": {k: float(v[p]) for k, v in launch["grad"].items()},
        "change": {k: float(v[p]) for k, v in launch["change"].items()},
        "bn": {k: float(v[p]) for k, v in launch["bn"].items()},
    }


def _leaf_gaps(cand: Dict, refd: Dict, paths) -> List[float]:
    """Per leaf, the gap between the two sides' norms against the
    reference's norm of that leaf or of the median leaf, the larger."""
    med = statistics.median([refd[p] for p in refd]) if refd else 0.0
    gaps = []
    for p in paths:
        r = refd.get(p, 0.0)
        c = cand.get(p, 0.0)
        den = max(r, med)
        if den > 0:
            gaps.append(abs(c - r) / den)
        else:
            gaps.append(float("inf") if c > 0 else 0.0)
    return gaps


def _gap_of_norms(cand: Dict, refd: Dict, paths) -> float:
    return max(_leaf_gaps(cand, refd, paths), default=0.0)


def step_numbers(cand: Dict, refd: Dict) -> Dict[str, float]:
    """The step numbers of one genome: ``cand`` (the program's lane, or a
    control or fault put in its place) against the f32 reference.

    The logits and the loss are compared at the first step, where both
    sides start from the same parameters (later steps add Adam's
    amplification of round-off: ``loss_gap_all_steps``). The first
    gradient by the median leaf's gap (``grad_gap``): the worst leaf
    (``grad_gap_worst_leaf``) is on every seed the stem conv's bias, a
    near-cancellation under BN that bfloat16 leaves as noise. The change
    and the BN state by their worst leaf."""
    c, r = cand["logits"][0].double(), refd["logits"][0].double()
    logit = (float(torch.linalg.vector_norm(c - r)
                   / torch.linalg.vector_norm(r))
             if c.shape == r.shape else float("inf"))
    losses = [abs(c - r) / abs(r) for c, r in zip(cand["loss"],
                                                   refd["loss"])]
    grads = _leaf_gaps(cand["grad"], refd["grad"],
                       sorted(set(cand["grad"]) | set(refd["grad"])))
    gmed = statistics.median(refd["grad"].values())
    moving = [p for p, g in refd["grad"].items() if g >= STILL_LEAF * gmed]
    change = _gap_of_norms(cand["change"],
                           {p: refd["change"][p] for p in moving}, moving)
    bn = (_gap_of_norms(cand["bn"], refd["bn"], refd["bn"])
          if refd["bn"] else 0.0)
    return {"logit_gap": logit, "loss_gap": losses[0],
            "loss_gap_all_steps": max(losses),
            "grad_gap": statistics.median(grads),
            "grad_gap_worst_leaf": max(grads),
            "change_gap": change, "bn_gap": bn}


def val_numbers(cand, refv) -> Dict[str, float]:
    """(loss, acc, fpr) of one genome's validation against the reference's."""
    return {"val_loss_gap": abs(cand[0] - refv[0]) / abs(refv[0]),
            "val_acc_gap": abs(cand[1] - refv[1]),
            "val_fpr_gap": abs(cand[2] - refv[2])}


def worst(rows: List[Dict[str, float]]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for r in rows:
        for k, v in r.items():
            out[k] = max(out.get(k, 0.0), v)
    return out


class Reference:
    """The reference's view of one cell's data, genomes and settings, and
    of its architecture through the configuration's module."""

    def __init__(self, config: Dict, data: Dict[str, np.ndarray], device):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.arch = reference.load(config["reference"])
        self.train_cfg = config["train"]
        self.template = self.train_cfg["template"]
        self.num_classes = self.train_cfg["num_classes"]
        self.device = torch.device(device)
        bs = self.train_cfg["batch_size"]
        self.train = frozen.pad_dataset(data["x_train"], data["y_train"], bs)
        self.x_val = torch.as_tensor(data["x_val"], device=self.device)
        self.y_val = torch.as_tensor(data["y_val"], device=self.device)
        self._steps: Dict = {}

    def init(self, genome: Dict, eval_seed: int):
        p, s = self.arch.init_params(
            eval_seed, self.template, int(genome["filters"]),
            int(genome["kernel_size"]), self.num_classes,
            int(genome["residual_blocks"]), genome)
        p, s = self.arch.reference_params(p, s, genome, self.template)
        return _to(p, self.device), _to(s, self.device)

    def steps(self, genome: Dict, eval_seed: int, precision="f32",
              half_batch=False):
        """(side record, batch labels and weights) of STEPS reference
        steps, from the genome's own init."""
        key = (frozen.genome_key(genome), eval_seed, precision, half_batch)
        if key not in self._steps:
            self._steps[key] = self._run_steps(genome, eval_seed, precision,
                                               half_batch)
        return self._steps[key]

    def _run_steps(self, genome, eval_seed, precision, half_batch):
        p0, s0 = self.init(genome, eval_seed)
        bt = batches(self.train, eval_seed, self.train_cfg["batch_size"],
                     STEPS, self.device)
        recs = training.train_steps(
            self.arch.forward, p0, s0, genome, self.template, bt,
            lr=self.train_cfg["learning_rate"],
            eps=self.train_cfg["adam_eps"],
            dropout_rate=self.train_cfg["dropout_rate"],
            precision=precision, half_batch=half_batch)
        return (side_record(recs, p0, s0, bool(genome["use_bn"])),
                [(b[1], b[2]) for b in bt])

    def size(self, genome: Dict) -> float:
        p, s = self.init(genome, 0)
        return training.size_mb(p, s)

    def validate(self, genome: Dict, params: Dict, state: Dict,
                 precision="f32"):
        p, s = self.arch.reference_params(params, state, genome,
                                          self.template)
        return training.validate(self.arch.forward, p, s, genome,
                                 self.template, self.x_val, self.y_val,
                                 self.num_classes, precision=precision)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def judge(reference: Reference, genomes: List[Dict], recorder: Recorder,
          fitness_last: List, eval_seed_first: int, restore_best: bool,
          answers: List) -> Dict:
    """The numbers of a run: the first call's steps, the last call's
    validation, every genome's size. ``fitness_last`` is the last call's
    answer, in genome order; ``answers`` every call's."""
    by_uid = {frozen.genome_uid(g): g for g in genomes}
    index = {frozen.genome_uid(g): i for i, g in enumerate(genomes)}
    notes = []
    steps_rows, val_rows, detail = [], [], []
    seen = set()
    launches = recorder.launch_records()
    for launch in launches:
        if launch["steps"] < STEPS or not launch["change"]:
            notes.append(f"a launch ran {launch['steps']} recorded steps")
            continue
        for p, uid in enumerate(launch["uids"]):
            if uid in seen:
                continue  # a padding lane repeats its launch's first genome
            seen.add(uid)
            g = by_uid[uid]
            refd, y_w = reference.steps(g, eval_seed_first)
            lane = program_lane(launch, p, y_w)
            steps_rows.append(step_numbers(lane, refd))
            detail.append({"genome": list(frozen.genome_key(g)),
                           **{f"{side}_{k}": d[k]
                              for side, d in (("program", lane),
                                              ("reference", refd))
                              for k in ("loss", "grad", "change", "bn")}})
    if seen != set(by_uid):
        notes.append(f"steps recorded for {len(seen)} of {len(by_uid)} "
                     "genomes")
    seen = set()
    for fin in recorder.finals:
        params = fin["best_params"] if restore_best else fin["params"]
        state = fin["best_state"] if restore_best else fin["state"]
        for p, uid in enumerate(fin["uids"]):
            if uid in seen:
                continue
            seen.add(uid)
            g = by_uid[uid]
            acc, _, fpr = fitness_last[index[uid]]
            r = reference.validate(g, _lane(params, p), _lane(state, p))
            val_rows.append(val_numbers((fin["val_loss"][p], acc, fpr), r))
    if seen != set(by_uid):
        notes.append(f"final validation kept for {len(seen)} of "
                     f"{len(by_uid)} genomes")
    sizes = [reference.size(g) for g in genomes]
    size_gap = max(abs(size - s) for call in answers
                   for s, (_, size, _) in zip(sizes, call))
    out = worst(steps_rows + val_rows)
    out["size_gap"] = size_gap
    for name in NAMES:
        out.setdefault(name, float("nan"))
    return {"numbers": out, "notes": notes, "detail": detail}


def verdict(numbers: Dict[str, float], limits: Dict[str, float],
            notes: List[str], failed: int):
    """(correct, the checks in the result line's form): the numbers the
    cell's limits bound, each with its limit."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = (not notes and failed == 0
          and all(np.isfinite(numbers[k]) and numbers[k] <= limits[k]
                  for k in limits))
    return ok, checks
