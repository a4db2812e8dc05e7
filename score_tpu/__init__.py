"""score_tpu — a sequential-recommendation engine in JAX.

A from-scratch JAX/XLA framework providing the capabilities of
qinjr/SCoRe (WSDM 2020, "Sequential Recommendation with Dual Side Neighbor-based
Collaborative Relation Modeling"). The reference mount is empty (SURVEY.md §0);
this build follows the reconstructed spec in SURVEY.md §2.4 and the milestone
ladder configs0..configs4 (config.py).

Layout (SURVEY.md §7.1):
    config.py      dataclass configs + configs0..configs4 presets
    sharding.py    Mesh, SpecLayout, row-sharded lookup (all-to-all / psum)
    data/          schema, synthetic raw logs, preprocessing, pipeline
    nn/            embed, co-attention, encoders, scorer, model
    train.py       train/eval driver
    metrics.py     AUC / HR@K / NDCG@K / MRR (device-side)
"""

__version__ = "0.1.0"
