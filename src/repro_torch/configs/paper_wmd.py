"""The paper's own workload config: V=100k vocabulary, w=300 embeddings,
N=5000 target documents (crawl-300d-2M subset + dbpedia statistics).
Same values as the reference's ``repro.configs.paper_wmd``."""
from dataclasses import dataclass


@dataclass(frozen=True)
class WmdConfig:
    vocab_size: int = 100_000
    embed_dim: int = 300
    n_docs: int = 5000
    max_words: int = 64          # ELL pad (dbpedia docs ~ 35 nnz)
    lam: float = 10.0
    n_iter: int = 15
    query_words: tuple = (19, 43)   # the paper's two profiled queries


CONFIG = WmdConfig()
