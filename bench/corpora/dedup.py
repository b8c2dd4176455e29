"""The near-duplicate corpus (``"corpus": "dedup"``), frozen: later
changes to the program do not change what is measured.

The law is the reference benchmark's fig8 corpus
(``src/repro_torch/data/corpus.py``'s ``dedup_corpus``). Base documents
of ``doc_words`` Zipf draws (``generate.draw_bags``: ranks drawn with
exponent ``zipf_a``, each distinct rank a uniformly drawn distinct word
id). Each of the ``n_docs // variants`` bases has ``variants`` variants,
laid down in an order shuffled from the seed. A variant takes its base's
frequencies times ``perturb.scale``, adds U(0, ``perturb.jitter``) to each
live word, and gives one uniformly chosen position a uniformly drawn word
id; where that id is already in the bag the two counts merge, so ids stay
distinct within a bag. Counts are normalised to frequencies.

The query pool holds further variants: pool query i is a variant of base
``perm_j[i mod B]``, ``perm_j`` a permutation of the B bases drawn from the
seed for the j-th run of B queries. Every query is thus a re-post with
``variants`` near-duplicates in the corpus, each block of 4 096 queries
holds every base 13 or 14 times at B = 312, and no query repeats.

``query_pool.words`` repeats the bases' law (a query is a variant of a
base), so that ``generate.make`` can draw the configuration's shapes too.
Everything is drawn in bulk on the run's device from the seed; the
embeddings are ``generate.make``'s. It imports nothing of the program.
"""
from __future__ import annotations

import torch

from bench.traffic import generate

# independent random streams of one seed, beside generate.py's
STREAM_VARIANTS = 5


def make(config: dict, seed: int, device) -> generate.Corpus:
    """The configuration's corpus and query pool for ``seed``."""
    return draw(config, seed, device)[0]


def draw(config: dict, seed: int, device):
    """(corpus, doc_base (N,), pool_base (P,)): the corpus and query pool
    of ``make``, with the base each document and pool query varies."""
    v, w = config["vocab_size"], config["embed_dim"]
    device = torch.device(device)
    vecs = torch.randn((v, w), generator=generate.generator(
        seed, generate.STREAM_EMBED, device), device=device,
        dtype=torch.float32)
    per = int(config["variants"])
    n_base = int(config["n_docs"]) // per
    bases = generate.draw_bags(
        generate.generator(seed, generate.STREAM_DOCS, device), n_base, v,
        config["doc_words"], config["zipf_a"])
    law = config["perturb"]
    gen = generate.generator(seed, STREAM_VARIANTS, device)
    doc_base = torch.arange(n_base, device=device).repeat_interleave(per)
    doc_base = doc_base[torch.randperm(doc_base.numel(), generator=gen,
                                       device=device)]
    docs = variants(gen, bases, doc_base, v, law)
    gen = generate.generator(seed, generate.STREAM_POOL, device)
    size = int(config["query_pool"]["size"])
    walks = torch.rand((-(-size // n_base), n_base), generator=gen,
                       dtype=torch.float64, device=device)
    pool_base = torch.argsort(walks, dim=1).flatten()[:size]
    pool = variants(gen, bases, pool_base, v, law)
    idx, val = generate.to_ell(docs)
    corpus = generate.Corpus(vecs=vecs, docs=docs, idx=idx, val=val,
                             pool=pool)
    return corpus, doc_base.cpu().numpy(), pool_base.cpu().numpy()


def variants(gen: torch.Generator, bases: generate.Bags,
             which: torch.Tensor, vocab: int, law: dict) -> generate.Bags:
    """Bag i a variant of base ``which[i]`` (the module's law), drawn on
    ``which``'s device."""
    dev = which.device
    ptr = torch.as_tensor(bases.ptr, device=dev)
    size = (ptr[1:] - ptr[:-1])[which]
    m = which.numel()
    row = torch.repeat_interleave(torch.arange(m, device=dev), size)
    start = torch.cumsum(size, 0) - size
    src = ptr[which][row] + torch.arange(row.numel(), device=dev) - start[row]
    ids = torch.as_tensor(bases.ids, device=dev)[src]
    cnt = (torch.as_tensor(bases.w, device=dev).double()[src] * law["scale"]
           + torch.rand(row.numel(), generator=gen, dtype=torch.float64,
                        device=dev) * law["jitter"])
    swap = start + torch.floor(torch.rand(m, generator=gen,
                                          dtype=torch.float64, device=dev)
                               * size).long()
    ids[swap] = torch.randint(0, vocab, (m,), generator=gen, device=dev)
    # an id drawn that the bag already holds merges with it
    key, inv = torch.unique(row * vocab + ids, return_inverse=True)
    merged = torch.zeros(key.numel(), dtype=torch.float64,
                         device=dev).index_add_(0, inv, cnt)
    bag = key // vocab
    total = torch.zeros(m, dtype=torch.float64,
                        device=dev).index_add_(0, bag, merged)
    sizes = torch.bincount(bag, minlength=m)
    ptr_out = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                         torch.cumsum(sizes, 0)])
    return generate.Bags(ptr=ptr_out.cpu().numpy(),
                         ids=(key % vocab).cpu().numpy(),
                         w=(merged / total[bag]).float().cpu().numpy())


def tiny(config: dict) -> dict:
    """The configuration cut for the CPU tests: six bases, a 4 096-word
    vocabulary at width 16, a pool of 256. (Over 512 words the bases share
    enough words that a query's 10th nearest is now and then another
    base's document.)"""
    return dict(config, vocab_size=4096, embed_dim=16,
                n_docs=6 * int(config["variants"]),
                query_pool=dict(config["query_pool"], size=256))
