"""solved_share_pct (program counter ``SearchResult.solved``; pruning):
documents that went through the exact solve, over queries times
documents, in the measured window."""


def read(run):
    solved = queries = 0
    for c in run.calls:
        if c.answers is None:
            continue
        for a in run.system.answers(c.answers):
            solved += a[2]
            queries += 1
    n = run.corpus.idx.shape[0]
    return 100.0 * solved / (queries * n) if queries else None
