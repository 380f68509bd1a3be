"""Batched streaming demo: score a corpus of pairs with bucketing,
checkpoint/resume spooling, and per-chunk metrics; shard over a device
mesh when more than one device is visible.

Run: python examples/batch_streaming.py [n_pairs]
(Use XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu
to demo mesh sharding without several GPUs.)
"""

import random
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np
from jax.sharding import Mesh

from bialign_tpu.parallel.driver import PairRecord, StreamingAligner

n_pairs = int(sys.argv[1]) if len(sys.argv) > 1 else 64
random.seed(0)

AA = "ARNDCQEGHILKMFPSTWYV"
SS = "HEC"


def rand_rec(i):
    L = random.randint(30, 90)
    seq = "".join(random.choice(AA) for _ in range(L))
    struc = "".join(random.choice(SS) for _ in range(L))
    L2 = max(10, L + random.randint(-5, 5))
    seq2 = "".join(random.choice(AA) for _ in range(L2))
    struc2 = "".join(random.choice(SS) for _ in range(L2))
    return PairRecord(f"pair{i}", seq, seq2, struc, struc2)


devices = np.array(jax.devices())
mesh = Mesh(devices, ("data",)) if len(devices) > 1 else None
print(f"{len(devices)} device(s); mesh={'data' if mesh else None}")

driver = StreamingAligner(
    dict(type="Protein", structure_weight=800, simmatrix="BLOSUM62",
         gap_opening_cost=-150, gap_cost=-50, shift_cost=-150,
         max_shift=1),
    mesh=mesh, spool_path="/tmp/bialign_scores.jsonl", chunk_pairs=32,
)

for pair_id, score in driver.run(rand_rec(i) for i in range(n_pairs)):
    pass

driver.stats.stop()
print(driver.stats.to_json())
print("results spooled to /tmp/bialign_scores.jsonl (resume-safe)")
