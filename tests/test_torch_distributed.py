"""obia_tpu_torch/parallel/distributed.py and the mesh spread over ranks,
on the CPU with gloo: start-up decisions against the JAX package's, and
two real worker processes started by chip_smoke.py's phase 24 (a
cross-process reduction, as tests/test_multihost.py does for JAX, one
shard row a rank, the mosaic refused on a mesh that spans ranks, and the
sharded train step equal bit for bit to the one-process step). Each
worker has a timeout, and the process group one of 60 s."""
import pytest
import torch
import torch.distributed as dist

import chip_smoke
from obia_tpu.parallel import distributed as jdist
from obia_tpu_torch.parallel import distributed as tdist
from obia_tpu_torch.parallel.mesh import make_mesh

SCENE = (256, 512)   # RGB, the dry run's shape
STEPS = 3
ENV_VARS = ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK",
            "LOCAL_WORLD_SIZE", "SLURM_NTASKS", "SLURM_JOB_NUM_NODES",
            "SLURM_PROCID", "SLURM_NTASKS_PER_NODE", "SLURM_LOCALID",
            "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK",
            "OMPI_COMM_WORLD_LOCAL_SIZE", "OMPI_COMM_WORLD_LOCAL_RANK",
            "PMI_SIZE", "PMI_RANK", "COORDINATOR_ADDRESS",
            "JAX_COORDINATOR_ADDRESS")

@pytest.fixture
def no_cluster_env(monkeypatch):
    for var in ENV_VARS:
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


@pytest.fixture(scope="module")
def two_ranks():
    """Phase 24 on the CPU: two gloo workers, each a new interpreter
    running ``chip_smoke.py --two-rank-worker``; their RESULT dicts (the
    helper raises where a worker fails or a check does not hold)."""
    return chip_smoke.two_rank_check("cpu", device="cpu", size=SCENE[0],
                                     width=SCENE[1], steps=STEPS,
                                     timeout=180)


def test_single_process_is_a_no_op(no_cluster_env):
    tdist.initialize()
    assert not dist.is_initialized()
    assert tdist.process_info() == {"process_index": 0, "process_count": 1,
                                    "local_devices": 1, "global_devices": 1}
    assert tdist.is_coordinator()


@pytest.mark.parametrize("var", ["SLURM_NTASKS", "SLURM_JOB_NUM_NODES",
                                 "OMPI_COMM_WORLD_SIZE", "PMI_SIZE"])
@pytest.mark.parametrize("value", ["1", "2", "16", "x"])
def test_cluster_detection_matches_jax(no_cluster_env, var, value):
    no_cluster_env.setenv(var, value)
    assert tdist._cluster_env_present() == jdist._cluster_env_present()
    assert tdist._cluster_env_present() == (value in ("2", "16"))


@pytest.mark.parametrize("value,present", [("1", False), ("2", True)])
def test_torchrun_world_size_is_a_cluster(no_cluster_env, value, present):
    no_cluster_env.setenv("WORLD_SIZE", value)
    assert tdist._cluster_env_present() is present


def test_cluster_without_rank_or_coordinator_raises(no_cluster_env):
    no_cluster_env.setenv("SLURM_NTASKS", "4")
    with pytest.raises(ValueError, match="process_id"):
        tdist.initialize()
    no_cluster_env.setenv("SLURM_PROCID", "1")
    with pytest.raises(ValueError, match="coordinator_address"):
        tdist.initialize()
    assert not dist.is_initialized()


@pytest.mark.parametrize("cards,world,want", [(0, 2, "gloo"), (2, 2, "nccl"),
                                              (4, 2, "nccl"), (1, 1, "nccl")])
def test_default_backend(monkeypatch, cards, world, want):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert tdist._default_backend(world) == want


# rank 9 of 16, on the second of two nodes of 8 cards: local rank 1
LAUNCHERS = {
    "torchrun": {"WORLD_SIZE": "16", "RANK": "9", "LOCAL_WORLD_SIZE": "8",
                 "LOCAL_RANK": "1"},
    "slurm": {"SLURM_NTASKS": "16", "SLURM_PROCID": "9",
              "SLURM_NTASKS_PER_NODE": "8", "SLURM_LOCALID": "1"},
    "openmpi": {"OMPI_COMM_WORLD_SIZE": "16", "OMPI_COMM_WORLD_RANK": "9",
                "OMPI_COMM_WORLD_LOCAL_SIZE": "8",
                "OMPI_COMM_WORLD_LOCAL_RANK": "1"},
}


@pytest.mark.parametrize("launcher", sorted(LAUNCHERS))
def test_two_nodes_take_nccl_on_their_local_card(no_cluster_env, launcher):
    """Two nodes of 8 cards: NCCL, each rank on its card of its own node,
    decided from the node's ranks, not the world's 16."""
    for var, value in LAUNCHERS[launcher].items():
        no_cluster_env.setenv(var, value)
    no_cluster_env.setattr(torch.cuda, "device_count", lambda: 8)
    calls = []
    no_cluster_env.setattr(torch.cuda, "set_device", calls.append)
    no_cluster_env.setattr(dist, "init_process_group",
                           lambda backend, **kw: calls.append((backend, kw)))
    tdist.initialize(coordinator_address="10.0.0.1:29500")
    card, (backend, kw) = calls
    assert (card, backend) == (1, "nccl")
    assert (kw["world_size"], kw["rank"]) == (16, 9)
    assert kw["init_method"] == "tcp://10.0.0.1:29500"


@pytest.mark.parametrize("launcher", sorted(LAUNCHERS))
def test_more_ranks_than_cards_on_a_node_raise(no_cluster_env, launcher):
    for var, value in LAUNCHERS[launcher].items():
        no_cluster_env.setenv(var, value)
    no_cluster_env.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(RuntimeError, match="8 ranks on 4 card"):
        tdist.initialize(coordinator_address="10.0.0.1:29500")
    assert not dist.is_initialized()


def test_two_nccl_ranks_on_one_card_raise(no_cluster_env):
    no_cluster_env.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        tdist.initialize(coordinator_address="127.0.0.1:1", num_processes=2,
                         process_id=0)
    assert not dist.is_initialized()


def test_distributed_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialise"):
        make_mesh(8, ["cpu"], distributed=True)


def test_two_process_reduction(two_ranks):
    assert [res["rank"] for res in two_ranks] == [0, 1]
    for r, res in enumerate(two_ranks):
        # 1 * 4 + 2 * 4 over both processes' (1, 4) tensors
        assert res["total"] == 12.0
        assert res["coordinator"] is (r == 0)
        assert res["info"] == {"process_index": r, "process_count": 2,
                               "local_devices": 1, "global_devices": 2}


def test_mesh_puts_one_shard_row_on_each_rank(two_ranks):
    for r, res in enumerate(two_ranks):
        assert [tuple(ij) for ij in res["held"]] == [(r, j) for j in range(4)]
        assert res["blocks"] == [[i == r] * 4 for i in range(2)]
        assert res["ragged_rows_refused"]


def test_mosaic_refuses_a_mesh_that_spans_ranks(two_ranks):
    for res in two_ranks:
        assert len(res["mosaic_refused"]) == 2
        assert all("spans ranks" in m for m in res["mosaic_refused"])


def test_two_ranks_equal_one_process_bitwise(two_ranks):
    for res in two_ranks:
        assert res["bitwise"] == sorted(["losses", "centers", "w1", "b1",
                                         "w2", "b2"])
        assert len(res["times"]) == STEPS
