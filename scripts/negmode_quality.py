"""Quality gate for in-batch negatives: train configs3
twice on the ladder dataset — train_neg_mode 'uniform' vs 'inbatch' — same
seed, same data, and compare val/test AUC. 'inbatch' eliminates the
per-negative embedding gathers + grad scatter-adds (the dominant step cost,
BASELINE.md scatter-add roofline) and becomes the bench default only if its
AUC is within run-to-run variance of 'uniform'.

Usage: python scripts/negmode_quality.py [epochs]
"""

import dataclasses
import json
import sys
import time

sys.path.insert(0, ".")

from score_tpu.config import configs3
from score_tpu.data.prep_datasets import PREP
from score_tpu.train import train


def main():
    epochs = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    ds = PREP["taobao"]("/tmp/score_tpu_data/ladder_taobao",
                        synth_kw=dict(num_users=3000, num_items=6000,
                                      num_events=400_000, mode="collab"))
    print(f"users={ds.num_users} items={ds.num_items} "
          f"train={len(ds.train)}", flush=True)
    modes = sys.argv[2].split(",") if len(sys.argv) > 2 else (
        "uniform", "inbatch", "inbatch_iw")
    results = {}
    for mode in modes:
        cfg = configs3()
        cfg = cfg.replace(
            data=dataclasses.replace(cfg.data, train_neg_mode=mode),
            train=cfg.train.__class__(
                batch_size=512, learning_rate=1e-3, num_epochs=epochs,
                eval_every_steps=300, early_stop_patience=6,
                log_every_steps=10 ** 9, seed=0))
        t0 = time.time()
        out = train(cfg, ds, verbose=False)
        results[mode] = dict(best_val_auc=out["best_val_auc"],
                             test_auc=out["test"]["auc"],
                             ndcg10=out["test"]["ndcg@10"],
                             wall_s=round(time.time() - t0, 1))
        print(json.dumps({mode: results[mode]}), flush=True)
    if "uniform" in results:
        for mode in results:
            if mode == "uniform":
                continue
            d = (results["uniform"]["best_val_auc"]
                 - results[mode]["best_val_auc"])
            print(json.dumps({f"val_auc_uniform_minus_{mode}": round(d, 5)}),
                  flush=True)


if __name__ == "__main__":
    main()
