"""Quickstart on the PyTorch port: Word Mover's Distance between documents.

    PYTHONPATH=src python examples/torch_quickstart.py              # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu  # host

Builds a toy vocabulary + embeddings, computes one-to-many WMD with each of
the port's solvers (``kernel`` runs the Hopper kernels on the card, their
plain versions on the host), and shows the nearest documents: documents
with disjoint words can still be close in embedding space.
"""
import argparse
import sys

sys.path.insert(0, "src")

import numpy as np  # noqa: E402

from repro_torch.core import one_to_many  # noqa: E402
from repro_torch.data.corpus import make_corpus  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' for the host)")
    args = ap.parse_args()
    corpus = make_corpus(vocab_size=4096, embed_dim=64, n_docs=256,
                         n_queries=1, seed=42)
    query = corpus.queries[0]
    # lam is scaled to the embedding norm: at w=64 distances are ~11, and
    # lam*M must stay well under ~87 or exp(-lam*M) underflows fp32
    for impl in ("dense", "sparse", "kernel"):
        d = one_to_many(query, corpus.docs, corpus.vecs, lam=3.0, n_iter=25,
                        impl=impl, device=args.device).cpu().numpy()
        top = np.argsort(d)[:5]
        print(f"{impl:8s} nearest docs: {top.tolist()}  "
              f"distances: {np.round(d[top].astype(float), 3).tolist()}")
    print(f"\ncorpus of {len(d)} docs  ->  WMD range "
          f"[{d.min():.2f}, {d.max():.2f}]  (lower = more similar)")


if __name__ == "__main__":
    main()
