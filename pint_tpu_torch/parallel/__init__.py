"""Multi-pulsar batching (pint_tpu parallel/): the pulsar axis of a
PTA as one batched program on one card.  The mesh over several cards
(pint_tpu parallel/mesh.py) is not ported (ROADMAP queue 1 item 13)."""

from pint_tpu_torch.parallel.pta import (  # noqa: F401
    PTABatch, make_superset_models)
