"""The paper's top-1 ratio over a pass: the summed device time of each
product at the measured-best configuration of its ``sm90`` space over the
summed time at the static tuner's pick, every configuration timed by
CUDA-graph replay."""


def read(r):
    oracle = r.extra.get("oracle")
    shapes = r.calls.get("shapes")
    if not oracle or not shapes:
        return None
    pick = sum(oracle[s][0] for s in shapes)
    best = sum(oracle[s][1] for s in shapes)
    return 100.0 * best / pick
