"""The port's train steps on gloo meshes for the recurrent archs, held
against the reference on the CPU: reduced jamba (attention, mamba and MoE
blocks) and xlstm-1.3b (mLSTM and sLSTM mixers), each on a 2 x 2 and a
1 x 4 ('data', 'model') mesh, two steps (the second with accum_steps=2,
int8 gradient compression and grad_shardings), against the port's meshless
steps and, on 2 x 2, the reference's steps jitted with in/out shardings on a
2 x 2 host mesh; and the 1 x 1 mesh step bit for bit. The mamba scan and
the xLSTM mixers run on each rank's batch rows (``pctx.map_rows``, the
reference's ``shard_map``). Tolerances: ``torch_dist_cases.close_steps``.
The cases of tests/test_torch_parallel.py, split off so that the two
reference compiles, the slowest part, run on two workers.
"""
import pickle

import pytest
import torch

import torch_dist_cases as cases

ARCHS = ("jamba_v01_52b", "xlstm_13b")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_hybrid")
    inputs = cases.write_train_inputs(tmp / "inputs.pt", ARCHS)
    with open(tmp / "ref_job.pkl", "wb") as f:
        pickle.dump({"archs": ARCHS, "lr": cases.LR,
                     "batches": {a: inputs[a]["batches"] for a in ARCHS}}, f)
    jobs = {
        "reference": cases.start_reference(tmp / "ref_job.pkl", tmp / "ref_out.pkl",
                                           devices=4),
        "2x2": cases.start("train", 4, tmp, tmp / "inputs.pt", name="t22", mesh=[2, 2],
                           archs=ARCHS),
        "1x4": cases.start("train", 4, tmp, tmp / "inputs.pt", name="t14", mesh=[1, 4],
                           archs=ARCHS, head_aware=True),
        "one_rank": cases.start("one_rank", 1, tmp, tmp / "inputs.pt", archs=ARCHS),
    }
    yield jobs
    for job in jobs.values():
        job.kill()


@pytest.mark.parametrize("arch", ARCHS)
def test_one_by_one_mesh_step_is_bit_equal_to_meshless(runs, arch):
    (mm, ml, placed, _), (pm, pl, _, _) = runs["one_rank"].result()[arch]
    assert placed and mm == pm
    assert len(ml) == len(pl) and all(torch.equal(a, b) for a, b in zip(ml, pl))
    (ml, mleaves), (pl, pleaves) = runs["one_rank"].result()[("trainer", arch)]
    assert ml == pl and len(mleaves) == len(pleaves)
    assert all(torch.equal(a, b) for a, b in zip(mleaves, pleaves))


@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_train_steps_match_meshless_and_reference(runs, arch, mesh):
    got = runs[mesh].result()[(arch, False)]
    assert got[2], "a leaf lost its rule placements"
    cases.close_steps(got, runs["one_rank"].result()[arch][1], arch, f"{mesh} vs meshless")
    if mesh == "2x2":
        cases.close_steps(got, runs["reference"].result()["train"][arch], arch,
                          "2x2 vs reference")
