"""setup.plan_s: host seconds of the first ``JoinDataset.plan`` access: the
plan build (`core.join_tree.build_plan`), its capacity buckets
(`core.plan_cache`) and the move of its tensors to the card (host clock)."""


def read(rec):
    return rec.setup.get("plan_s")
