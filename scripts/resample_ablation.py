"""Neighbor re-sampling quality ablation (SURVEY.md §2.3 #5): does
restoring the reference's draw-per-occurrence sampler semantics
(fresh uniform neighbor subset every step, `data.neighbor_resample=true`)
help or hurt vs the prep-time fixed sample?

Protocol: the pinned crossattr ladder dataset at model fan-out (10) is the
OFF arm; the ON arm preps the SAME generator at 2x fan-out (20) and
subsamples to 10 on device each step (graph.subsample_neighbors). configs3,
same train knobs as scripts/ladder.py, seeds {0,1,2}.

Usage: python scripts/resample_ablation.py [out_json] [epochs]
"""

import json
import sys
import time

sys.path.insert(0, ".")

from score_tpu.config import PRESETS

GEN_KW = dict(num_users=3000, num_items=6000, num_events=400_000,
              mode="crossattr", drift_active=3.0, sig_frac=0.7, junk_frac=0.2)
SEEDS = (0, 1, 2)


def main():
    from score_tpu.data.prep_datasets import PREP
    from score_tpu.train import train
    out_path = sys.argv[1] if len(sys.argv) > 1 else "/tmp/resample_abl.json"
    epochs = int(sys.argv[2]) if len(sys.argv) > 2 else 4

    ds10 = PREP["taobao"]("/tmp/score_tpu_data/ladder_taobao_crossattr",
                          raw_path="/tmp/score_tpu_raw/ladder_taobao_crossattr.csv",
                          synth_kw=GEN_KW)
    ds20 = PREP["taobao"]("/tmp/score_tpu_data/ladder_taobao_crossattr_f20",
                          raw_path="/tmp/score_tpu_raw/ladder_taobao_crossattr.csv",
                          synth_kw=GEN_KW, user_fanout=20, item_fanout=20)
    print(f"off-arm fanout={ds10.graph.u2i.shape[-1]} "
          f"on-arm fanout={ds20.graph.u2i.shape[-1]}", flush=True)

    results = {}
    for arm, ds, resample in (("fixed_prep_sample", ds10, False),
                              ("per_step_resample", ds20, True)):
        results[arm] = []
        for seed in SEEDS:
            cfg = PRESETS["configs3"]()
            cfg = cfg.replace(
                data=cfg.data.__class__(neighbor_resample=resample),
                train=cfg.train.__class__(
                    batch_size=512, learning_rate=1e-3, num_epochs=epochs,
                    eval_every_steps=300, early_stop_patience=6,
                    log_every_steps=10 ** 9, seed=seed))
            t0 = time.time()
            out = train(cfg, ds, verbose=False)
            rec = dict(seed=seed, best_val_auc=out["best_val_auc"],
                       test_auc=out["test"]["auc"],
                       ndcg10=out["test"]["ndcg@10"],
                       wall_s=round(time.time() - t0, 1))
            results[arm].append(rec)
            print(f"{arm} seed={seed}: val_auc={rec['best_val_auc']:.4f} "
                  f"test_auc={rec['test_auc']:.4f} "
                  f"ndcg@10={rec['ndcg10']:.4f} wall={rec['wall_s']}s",
                  flush=True)

    import numpy as np
    for arm in results:
        v = [r["best_val_auc"] for r in results[arm]]
        print(f"{arm}: val_auc mean={np.mean(v):.4f} sd={np.std(v):.4f}",
              flush=True)
    with open(out_path, "w") as f:
        json.dump(results, f, indent=2)


if __name__ == "__main__":
    main()
