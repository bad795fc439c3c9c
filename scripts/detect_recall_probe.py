"""Quick detect-recall gate: candidate recall/precision vs simulated
truth (>=2 kb genomic overlap) at a given scale. Guards counting-path
changes against silent recall drift. Run from the repository root:
  G=800000 python scripts/detect_recall_probe.py
"""
import os
import sys

import numpy as np

from bella_tpu import BellaConfig
from bella_tpu.io.simulate import random_genome, sample_reads
from bella_tpu.overlap.pairs import detect_overlaps
from bella_tpu.eval.evaluate import truth_pairs

GENOME = int(os.environ.get("G", 800_000))
cfg = BellaConfig()
g = random_genome(GENOME, seed=0)
n = GENOME * 25 // 6000
reads, truth = sample_reads(g, n, mean_len=6000, min_len=1000,
                            error_rate=0.15, seed=1)
pairs, num_kmers, nnz = detect_overlaps(reads, cfg)
print(f"reads={reads.num_reads} nnz={nnz} pairs={pairs.num_pairs}",
      file=sys.stderr)

# truth rows: (ref, name, start, end); circular reads wrap past G —
# truth_pairs sweeps linear intervals, so append a +G-shifted copy of
# every interval and dedup (a wrapping pair then meets in one frame)
rows = [(name, s, e) for _, name, s, e in truth]
rows += [(name, s + GENOME, e + GENOME) for _, name, s, e in truth
         if e > GENOME]
rows += [(name, s - GENOME, e - GENOME) for _, name, s, e in truth
         if e > GENOME]
tp = truth_pairs({"genome": rows}, min_overlap=2000)
tset = {tuple(sorted(p)) for p in tp}
names = np.array(reads.names)
found = {tuple(sorted((names[h], names[v])))
         for h, v in zip(pairs.read_h.tolist(), pairs.read_v.tolist())}
inter = len(tset & found)
rc = inter / max(len(tset), 1) * 100
pr = inter / max(len(found), 1) * 100
print(f"truth={len(tset)} found={len(found)} RC={rc:.2f} PR={pr:.2f}")
