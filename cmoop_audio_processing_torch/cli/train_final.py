"""Train and export one selected Pareto-point architecture.

The reference workflow stops at the front CSV — every trained model was
discarded during the search (clear_session per candidate,
sa_nsga_penalty.py:211-212), leaving deployment retraining to the user.
This command is that missing last mile: pick a row from a final Pareto CSV
(or spell out the genome), retrain it with the exact search-time semantics,
and write a reloadable model directory (engine/export.py) in the JAX
package's format.

    # retrain row 0 of a front with the preset's data/training settings
    python -m cmoop_audio_processing_torch.cli.train_final \
        --preset nsga_penalty --front results/nsga_penalty/final_pareto.csv \
        --row 0 --out results/deployed_model [--seed 0]

    # or specify the genome directly
    python -m cmoop_audio_processing_torch.cli.train_final \
        --preset nsga_penalty --filters 16 --kernel-size 3 --use-bn 1 \
        --residual-blocks 2 --fc-layers 1 --use-dropout 0 --out model/

The parser is the JAX command's plus ``--device {cuda,cpu}`` (default
cuda). ``--keras``/``--tflite``/``--tflite-int8`` need tensorflow, which
they import when asked for.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys


def genome_from_row(front_csv: str, row: int):
    from ..utils.xlsx import read_rows

    columns, rows = read_rows(front_csv)
    if not (0 <= row < len(rows)):
        raise SystemExit(f"--row {row} out of range: {front_csv} has {len(rows)} rows")
    r = dict(zip(columns, rows[row]))

    def as_bool(v):
        # strict whitelist of BOTH spellings: a float-typed column (1.0/0.0)
        # or an unrecognized cell must not silently train the wrong
        # architecture
        s = str(v).strip().lower()
        if s in ("true", "1", "1.0"):
            return True
        if s in ("false", "0", "0.0"):
            return False
        raise SystemExit(f"unrecognized boolean cell {v!r} in {front_csv}")

    return {
        "filters": int(r["filters"]),
        "kernel_size": int(r["kernel_size"]),
        "use_bn": as_bool(r["use_bn"]),
        "residual_blocks": int(r["residual_blocks"]),
        "fc_layers": int(r["fc_layers"]),
        "use_dropout": as_bool(r["use_dropout"]),
    }


def main(argv=None) -> int:
    from ..core.config import get_preset
    from ..data.pipeline import prepare_dataset
    from ..engine.export import save_model, train_single

    p = argparse.ArgumentParser(prog="cmoop-torch-train-final")
    p.add_argument("--preset", required=True,
                   help="preset supplying the data + training configuration")
    p.add_argument("--front", help="final Pareto CSV to pick the genome from")
    p.add_argument("--row", type=int, default=0,
                   help="row of --front to train (default 0)")
    p.add_argument("--filters", type=int)
    p.add_argument("--kernel-size", type=int)
    p.add_argument("--use-bn", type=int)
    p.add_argument("--residual-blocks", type=int)
    p.add_argument("--fc-layers", type=int)
    p.add_argument("--use-dropout", type=int)
    p.add_argument("--source", choices=["npy", "hdf5", "synthetic"])
    p.add_argument("--data-path")
    p.add_argument("--epochs", type=int)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", required=True, help="model output directory")
    p.add_argument("--keras", metavar="PATH",
                   help="additionally realize the trained genome as a "
                        "concrete Keras model (.h5/.keras; needs tensorflow)")
    p.add_argument("--tflite", metavar="PATH",
                   help="additionally convert to a float32 TFLite "
                        "flatbuffer (needs tensorflow)")
    p.add_argument("--tflite-int8", metavar="PATH",
                   help="additionally emit a full-integer int8 TFLite "
                        "flatbuffer, calibrated on the training features")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="device of the training (default cuda)")
    args = p.parse_args(argv)

    if args.front:
        genome = genome_from_row(args.front, args.row)
    else:
        gene_args = [args.filters, args.kernel_size, args.use_bn,
                     args.residual_blocks, args.fc_layers, args.use_dropout]
        if any(a is None for a in gene_args):
            raise SystemExit(
                "specify either --front (+--row) or ALL six gene flags"
            )
        genome = {
            "filters": args.filters,
            "kernel_size": args.kernel_size,
            "use_bn": bool(args.use_bn),
            "residual_blocks": args.residual_blocks,
            "fc_layers": args.fc_layers,
            "use_dropout": bool(args.use_dropout),
        }

    cfg = get_preset(args.preset)
    data_cfg = cfg.data
    if args.source:
        data_cfg = dataclasses.replace(data_cfg, source=args.source)
    if args.data_path:
        data_cfg = dataclasses.replace(data_cfg, path=args.data_path)
    train_cfg = cfg.train
    if args.epochs is not None:
        train_cfg = dataclasses.replace(train_cfg, epochs=args.epochs)

    data = prepare_dataset(data_cfg)
    print(f"training {genome} (seed {args.seed}) ...", file=sys.stderr)
    params, state, metrics = train_single(genome, data, train_cfg, args.seed,
                                          device=args.device)
    save_model(
        args.out, genome, train_cfg, params, state, metrics, args.seed,
        input_hw=data["x_train"].shape[1:3],
    )
    result = {"model_dir": args.out, **metrics}
    if args.keras or args.tflite or args.tflite_int8:
        from ..models.keras_export import export_keras, export_tflite

        model = export_keras(args.out, args.keras)
        if args.keras:
            result["keras"] = args.keras
        if args.tflite:
            result["tflite_bytes"] = export_tflite(model, args.tflite)
            result["tflite"] = args.tflite
        if args.tflite_int8:
            result["tflite_int8_bytes"] = export_tflite(
                model, args.tflite_int8, rep_data=data["x_train"][:128]
            )
            result["tflite_int8"] = args.tflite_int8
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
