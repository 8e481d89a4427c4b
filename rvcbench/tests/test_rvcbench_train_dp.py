"""The data-parallel training cell over gloo on the CPU at a tiny size:
rank 0 in this process and one spawned rank, as a run drives them (the
look for cards skipped); and the reference's data-parallel step, whose
slices' averaged gradient is the whole batch's."""

import copy
import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from rvcbench import run
from rvcbench.drivers.train import _kept, _leaf_gaps, leaf_norms
from rvcbench.drivers.train_dp import free_port
from rvcbench.lib import cells, trainset
from rvcbench.lib.inputs import small_model_config
from rvcbench.ref.train import Trainer, first_grads
from rvcbench.ref.train_data import Batches
from rvcbench.ref.train_dp import SliceTrainer
from rvcbench.tests.tiny import tiny_train

torch.set_num_threads(2)
NAME = "v2-40k.train-dp4"


def two_ranks():
    cell, cfg = tiny_train(NAME)
    cell.update(chips=2, batch_size=2)
    return cell, cfg


def test_a_traced_run_over_two_ranks(tmp_path):
    cell, cfg = two_ranks()
    out = run.run_cell(NAME, 3 * 2 ** 31 + 9, 2.0, True, "cpu",
                       str(tmp_path), cell=cell, cfg=cfg)
    try:
        rec = out["rec"]
        print(out["checks"])
        assert run.passed(out["checks"]), out["checks"]
        gap = [c for c in out["checks"] if c["name"] == "replica_gap"]
        assert gap == [{"name": "replica_gap", "value": 0.0, "limit": 0}]
        assert rec["attempted"] > 0 and rec["failed"] == 0
        for m in cells.metrics_for(NAME, False) + \
                cells.metrics_for(NAME, True):
            value = cells.metric(m["name"]).read(rec)
            print(m["name"], value)
            assert value is not None and value > 0, m["name"]
        assert run.forbidden_modules() == []
    finally:
        out["driver"].close()
    assert not dist.is_initialized()


def _slice_grads(rank, world, port, tmp, q):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        cfg, g, d, batch = torch.load(os.path.join(tmp, "case.pt"),
                                      weights_only=False)
        tr = SliceTrainer(cfg, small_model_config(cfg), g, d, "cpu", 4,
                          dist.group.WORLD, dtype=None)
        local = {k: v[rank::world] for k, v in batch.items()}
        out = tr.train_step(local)
        q.put((rank, [float(out["loss_disc"]), float(out["loss_gen_all"])],
               [float(out["rank_loss_disc"]),
                float(out["rank_loss_gen_all"])],
               leaf_norms(first_grads(tr.opt_g, list(tr.net_g.parameters()))
                          + first_grads(tr.opt_d,
                                        list(tr.net_d.parameters())))))
    finally:
        dist.destroy_process_group()


def test_the_slices_averaged_gradient_is_the_whole_batchs(tmp_path):
    """Two slices of two rows, each on its rank, against the reference's
    one-process step on the four: the losses (the group's, and the mean
    of the slices' own) and every leaf's first gradient agree to fp32's
    rounding (relative 1e-4, the worst leaf the cell compares, by the
    cell's own measure: the same sums in another order), in fp32 so that
    bf16's rounding does not hide a missing term."""
    cell, cfg = two_ranks()
    cfg = copy.deepcopy(cfg)
    g, d = trainset.weights_for_training(cfg, 2 ** 32 + 3, "cpu")
    filelist = trainset.write(str(tmp_path / "exp"), cfg, cell, 2 ** 32 + 3,
                              "cpu")
    plan = Batches(filelist, cfg["data"]["hop_length"], 4, 5)
    batch = {k: torch.as_tensor(v) for k, v in
             plan.batch(*plan.plan(0)[0]).items()}
    whole = Trainer(cfg, small_model_config(cfg), g, d, "cpu", 4,
                    dtype=None)
    want = whole.train_step(batch)
    want_g = leaf_norms(first_grads(whole.opt_g,
                                    list(whole.net_g.parameters()))
                        + first_grads(whole.opt_d,
                                      list(whole.net_d.parameters())))
    torch.save((cfg, g, d, batch), tmp_path / "case.pt")
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_slice_grads,
                         args=(r, 2, port, str(tmp_path), q))
             for r in range(2)]
    for p in procs:
        p.start()
    got = dict((r, (l, own, gr)) for r, l, own, gr in
               (q.get(timeout=300) for _ in procs))
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive() and p.exitcode == 0
    np.testing.assert_allclose(   # the slices' own losses average to it
        np.mean([got[r][1] for r in range(2)], axis=0),
        [float(want["loss_disc"]), float(want["loss_gen_all"])], rtol=1e-4)
    for r in range(2):
        losses, _, grads = got[r]
        np.testing.assert_allclose(
            losses, [float(want["loss_disc"]), float(want["loss_gen_all"])],
            rtol=1e-4)
        gaps = _leaf_gaps(grads, want_g, _kept(want_g))
        print("rank", r, "worst kept leaf", max(gaps))
        assert max(gaps) < 1e-4
