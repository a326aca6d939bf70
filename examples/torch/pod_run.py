"""Several processes, one corpus (the twin of ``examples/pod_run.py``):
run the same script in every process, one a GPU.

Each process joins the gloo group from the environment ``torchrun`` sets
(``parallel/dist``), takes its strided shard of the corpus listing,
extracts features for it on its own card (data stays local), and takes
part in the global CMVN reduction, the only traffic between processes: a
count and two small float64 vectors.

A single process runs it too (no group), so this is also the
one-machine corpus driver:

    python examples/torch/pod_run.py corpus_dir/ out_dir/ [--device cpu]
    torchrun --nproc-per-node 4 examples/torch/pod_run.py corpus/ out/
"""

import argparse

from mfcc_tpu_torch import FeatureConfig
from mfcc_tpu_torch.parallel import dist
from mfcc_tpu_torch.runner import RunnerOptions, run


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("corpus")
    ap.add_argument("out")
    ap.add_argument("--device", default="cuda",
                    help="cuda (cuda:{LOCAL_RANK} under torchrun) or cpu")
    args = ap.parse_args()
    dist.initialize()                      # a no-op in one process
    cfg = FeatureConfig(cmvn=True).validate()
    rep = run(args.corpus, cfg, RunnerOptions(out_dir=args.out,
                                              batch_size=32,
                                              device=args.device))
    if dist.is_coordinator():
        print(rep.dump())


if __name__ == "__main__":
    main()
