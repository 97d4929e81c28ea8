"""One-command evaluation with given weights: weights + vocabulary +
dataset root in, an ATE table and a pass/fail tolerance verdict out (the
port's vista_slam_tpu/cli/reproduce.py; the reference's flow is
load-weights -> load-ORBvoc -> per-scene SLAM -> ATE, evaluation_tumrgbd.py:
37,121-143 with vista_slam/slam.py:95-106 and loop_detector.py:6-7):

  python -m vista_slam_tpu_torch.cli.reproduce \
      --weights pretrains/frontend_sta_weights.pth \
      --vocab pretrains/ORBvoc.txt \
      --dataset tumrgbd --data-root /data/tumrgbd \
      --reference-ate my_reference_ate.json

Steps:
  1. Materialise a config from the dataset's default YAML with the weights
     and vocabulary injected: a reference ``.pth`` goes in as
     ``sta_torch_weights``, which the port loads as it is (its state-dict
     layout is the port's); an ``.npz`` of the JAX package goes in as
     ``sta_weights``.
  2. Run the evaluate entry point (all scenes, or --scenes).
  3. Hold each scene's ATE RMSE against --reference-ate (a JSON mapping
     scene -> reference ATE in metres) under --tolerance (default 5%),
     write ``reproduce_report.json``, and exit 1 if any scene misses it.
Without --reference-ate the table is written without a verdict.
"""

from __future__ import annotations

import argparse
import json
import os

from ..utils.logging import Channel, log

# dataset -> the config shipped for it (the reference pairs each
# evaluation_*.py with a config the same way: evaluation_tumrgbd.py:31)
_DEFAULT_CONFIGS = {
    "tumrgbd": "configs/tumrgbd.yaml",
    "tumrgbd_f2f3": "configs/tumrgbd.yaml",
    "7scenes": "configs/7scenes.yaml",
    "replica": "configs/default.yaml",
    "scannet": "configs/default.yaml",
}


def _materialize_config(base_cfg_path: str, weights: str, vocab: str | None,
                        out_dir: str) -> str:
    import yaml

    with open(base_cfg_path) as f:
        data = yaml.safe_load(f) or {}
    npz = weights.endswith(".npz")
    data["sta_weights"] = weights if npz else None
    data["sta_torch_weights"] = None if npz else weights
    data["vocab_path"] = vocab
    data["output_dir"] = out_dir
    os.makedirs(out_dir, exist_ok=True)
    cfg_path = os.path.join(out_dir, "reproduce_config.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(data, f)
    return cfg_path


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--weights", required=True,
                    help="reference-layout .pth (e.g. frontend_sta_weights.pth), "
                         "or the JAX package's .npz")
    ap.add_argument("--vocab", default=None,
                    help="ORBvoc.txt (DBoW text) or trained .npz vocabulary; "
                         "omitting it disables loop closure (changes ATE!)")
    ap.add_argument("--dataset", default="tumrgbd", choices=sorted(_DEFAULT_CONFIGS))
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--config", default=None,
                    help="base config YAML (default: the dataset's shipped config)")
    ap.add_argument("--scenes", nargs="*", default=None)
    ap.add_argument("--recon", action="store_true")
    ap.add_argument("--output", default="output/reproduce")
    ap.add_argument("--reference-ate", default=None,
                    help="JSON file mapping scene -> reference ATE RMSE (metres)")
    ap.add_argument("--tolerance", type=float, default=0.05,
                    help="allowed relative ATE regression against the reference "
                         "(default 0.05)")
    args = ap.parse_args(argv)

    if not os.path.exists(args.weights):
        ap.error(f"weights not found: {args.weights}")
    if args.vocab and not os.path.exists(args.vocab):
        ap.error(f"vocabulary not found: {args.vocab}")
    if args.vocab is None:
        log("no vocabulary given: loop closure DISABLED; trajectories on loopy "
            "sequences will NOT match the reference", Channel.WARNING)

    cfg_path = _materialize_config(args.config or _DEFAULT_CONFIGS[args.dataset],
                                   args.weights, args.vocab, args.output)

    from .evaluate import main as evaluate_main

    eval_args = ["--dataset", args.dataset, "--data-root", args.data_root,
                 "--config", cfg_path]
    if args.scenes:
        eval_args += ["--scenes", *args.scenes]
    if args.recon:
        eval_args += ["--recon"]
    results = evaluate_main(eval_args)

    reference = {}
    if args.reference_ate:
        with open(args.reference_ate) as f:
            reference = json.load(f)

    rows, failures = [], []
    for scene, r in results.items():
        row = {"scene": scene, "ate_rmse": float(r["ate_rmse"]),
               "n_keyframes": int(r["n_keyframes"])}
        if scene in reference:
            ref = float(reference[scene])
            rel = (row["ate_rmse"] - ref) / max(ref, 1e-12)
            row.update(reference_ate=ref, rel_delta=rel, ok=bool(rel <= args.tolerance))
            if not row["ok"]:
                failures.append(scene)
        rows.append(row)

    log("=" * 62, Channel.EVAL)
    log(f"{'scene':<28}{'ATE RMSE':>10}{'reference':>10}{'delta':>8}  verdict",
        Channel.EVAL)
    for row in rows:
        if "reference_ate" in row:
            log(f"{row['scene']:<28}{row['ate_rmse']:>10.4f}{row['reference_ate']:>10.4f}"
                f"{row['rel_delta']:>+7.1%}  {'PASS' if row['ok'] else 'FAIL'}",
                Channel.EVAL)
        else:
            log(f"{row['scene']:<28}{row['ate_rmse']:>10.4f}{'-':>10}{'-':>8}  "
                "(no reference)", Channel.EVAL)

    report = {"dataset": args.dataset, "tolerance": args.tolerance,
              "weights": args.weights, "vocab": args.vocab, "scenes": rows,
              "failures": failures}
    report_path = os.path.join(args.output, "reproduce_report.json")
    with open(report_path, "w") as f:
        json.dump(report, f, indent=2)
    log(f"report written to {report_path}", Channel.EVAL)

    if failures:
        log(f"TOLERANCE FAILURES: {failures}", Channel.EVAL)
        raise SystemExit(1)
    return report


if __name__ == "__main__":
    main()
