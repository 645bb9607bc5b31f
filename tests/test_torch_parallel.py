"""The port's data-parallel layer (``ace_tpu_torch/parallel/``) in one
process: ``MeshConfig.build`` against ``ace_tpu``'s over the same counts
(``tests/conftest.py`` gives ``ace_tpu`` 8 virtual CPU devices), the rows
of ``BatchPlacement`` against ``ace_tpu``'s, ``format_comm_stats``
byte for byte, the refusal of a spatial mesh, the launch variables, the
global batch's random draws, the gradient buckets and their counts, the
device under a process group, and ``mesh: {data_parallel: 1}`` without a
process group bit for bit as no mesh in the training and inference
entries."""

import os
import socket
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from ace_tpu.parallel import comm_stats as jax_comm_stats
from ace_tpu.parallel.distributed import BatchPlacement as JaxBatchPlacement
from ace_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from ace_tpu.testing import SyntheticData
from ace_tpu_torch.device import get_device
from ace_tpu_torch.parallel import comm_stats, distributed
from ace_tpu_torch.parallel.distributed import (
    BatchPlacement,
    DistributedConfig,
    randn_rows,
    row_generator,
)
from ace_tpu_torch.parallel.mesh import MeshConfig
from ace_tpu_torch.stepper.checkpoint import read_train_checkpoint
from tests.test_train_integration import ALL_NAMES
from tests.test_train_integration import _config as sfno_config

torch.set_num_threads(2)

COUNTS = [1, 2, 4, 8]
DATA_MESHES = [(-1, 1, 1), (1, 1, 1), (2, 1, 1), (3, 1, 1), (4, 1, 1),
               (8, 1, 1)]
SPATIAL_MESHES = [(-1, 2, 1), (2, 2, 2), (1, 1, 8), (-1, 4, 2)]


def _outcome(build):
    try:
        return build()
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("n", COUNTS)
@pytest.mark.parametrize("shape", DATA_MESHES, ids=str)
def test_mesh_builds_as_ace_tpu(shape, n):
    """The same mesh shape, or the same ValueError, over the same count;
    rank r sits where ``ace_tpu`` puts device r."""
    devices = jax.devices()[:n]
    ref = _outcome(lambda: JaxMeshConfig(*shape).build(devices))
    for rank in range(n):
        got = _outcome(lambda: MeshConfig(*shape).build(n, rank))
        if isinstance(ref, tuple):
            assert got == ref
            continue
        assert ref.devices.shape == (got.n_data, 1, 1)
        coords = np.argwhere(ref.devices == devices[rank])[0]
        assert (got.coord, 0, 0) == tuple(int(c) for c in coords)


@pytest.mark.parametrize("shape", SPATIAL_MESHES, ids=str)
def test_a_spatial_mesh_is_refused_naming_5b(shape):
    """``h * w > 1`` is refused as the config is read (also through an
    entry's config), naming ROADMAP Queue 1 item 5b."""
    from ace_tpu_torch.core.config import from_dict
    from ace_tpu_torch.inference.evaluator import EvaluatorConfig

    with pytest.raises(NotImplementedError, match="Queue 1 item 5b"):
        MeshConfig(*shape)
    with pytest.raises(NotImplementedError, match="item 5b"):
        from_dict(EvaluatorConfig, {
            "experiment_dir": "x", "checkpoint_path": "x",
            "n_forward_steps": 1, "loader": {"dataset": {"data_path": "x"}},
            "mesh": dict(zip(("data_parallel", "h", "w"), shape))})


@pytest.mark.parametrize("n_data", [1, 2, 4])
@pytest.mark.parametrize("global_batch", [2, 4, 6, 8])
def test_local_rows_are_ace_tpus(n_data, global_batch):
    """Each data coordinate's rows of a global batch, and the global batch
    of a local one, as ``ace_tpu``'s process that owns that coordinate
    has them (or its error where the batch does not divide)."""
    ref_mesh = JaxMeshConfig(n_data).build(jax.devices()[:n_data])
    for coord in range(n_data):
        ref = JaxBatchPlacement(ref_mesh)
        ref._local_data_coords = [coord]
        got = BatchPlacement(MeshConfig(n_data).build(n_data, coord), "cpu")
        want = _outcome(lambda: ref.local_rows(global_batch))
        rows = _outcome(lambda: got.local_rows(global_batch))
        if isinstance(want, tuple):
            assert rows == want
            continue
        np.testing.assert_array_equal(rows, want)
        assert got.global_batch_of(len(rows)) == ref.global_batch_of(
            len(want)) == global_batch


@pytest.mark.parametrize("stats", [
    {},
    {"all-reduce": {"count": 3, "bytes": 123_456_789}},
    {"all-gather": {"count": 1, "bytes": 5}, "all-reduce": {
        "count": 12, "bytes": 2_985_000_000}, "broadcast": {
            "count": 2, "bytes": 1_000_000}},
])
def test_format_comm_stats_is_ace_tpus(stats):
    assert comm_stats.format_comm_stats(stats) == (
        jax_comm_stats.format_comm_stats(stats))


@pytest.mark.parametrize("env, want", [
    ({"ACE_TPU_COORDINATOR_ADDRESS": "h:1", "ACE_TPU_NUM_PROCESSES": "4",
      "ACE_TPU_PROCESS_ID": "3"}, ("h:1", 4, 3, 3)),
    ({"ACE_TPU_COORDINATOR_ADDRESS": "h:1", "ACE_TPU_NUM_PROCESSES": "2",
      "ACE_TPU_PROCESS_ID": "1", "LOCAL_RANK": "0"}, ("h:1", 2, 1, 0)),
    ({"RANK": "5", "WORLD_SIZE": "8", "LOCAL_RANK": "1",
      "MASTER_ADDR": "m", "MASTER_PORT": "9"}, ("m:9", 8, 5, 1)),
    ({"SLURM_NTASKS": "4", "SLURM_PROCID": "2", "SLURM_LOCALID": "2",
      "MASTER_ADDR": "s", "MASTER_PORT": "7"}, ("s:7", 4, 2, 2)),
    ({"SLURM_NTASKS": "1", "SLURM_PROCID": "0"}, (None, None, None, None)),
    ({}, (None, None, None, None)),
])
def test_launch_variables(env, want, monkeypatch):
    """Explicit ``ACE_TPU_*``, torchrun's and SLURM's variables; a
    single-task launch is no group."""
    for name in ("ACE_TPU_COORDINATOR_ADDRESS", "ACE_TPU_NUM_PROCESSES",
                 "ACE_TPU_PROCESS_ID", "RANK", "WORLD_SIZE", "LOCAL_RANK",
                 "MASTER_ADDR", "MASTER_PORT", "SLURM_NTASKS",
                 "SLURM_PROCID", "SLURM_LOCALID"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    got = DistributedConfig.from_env()
    assert (got.coordinator_address, got.num_processes, got.process_id,
            got.local_rank) == want
    assert got.explicit == (want[0] is not None)


def test_a_slurm_launch_needs_the_master_address(monkeypatch):
    for name in ("ACE_TPU_COORDINATOR_ADDRESS", "RANK", "MASTER_ADDR"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("SLURM_NTASKS", "2")
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        DistributedConfig.from_env()


@pytest.mark.parametrize("n_shards", [2, 4])
def test_row_draws_are_the_global_batch_draw(n_shards):
    """Each shard's draw is its block of rows of one generator's draw for
    the global batch, and every shard's generator ends where that one
    does."""
    whole = torch.Generator().manual_seed(5)
    want = torch.randn((2 * n_shards, 3, 4), generator=whole)
    for k in range(n_shards):
        gen = row_generator("cpu", 5, n_shards, k)
        got = randn_rows((2, 3, 4), gen, "cpu")
        assert torch.equal(got, want[2 * k:2 * k + 2])
        assert torch.equal(gen.get_state(), whole.get_state())


def test_buckets_group_consecutive_tensors_of_one_dtype():
    ts = [torch.zeros(10), torch.zeros(10), torch.zeros(30),
          torch.zeros(5, dtype=torch.float64), torch.zeros(2)]
    sizes = [[t.numel() for t in b]
             for b in distributed._buckets(ts, cap=100)]
    assert sizes == [[10, 10], [30], [5], [2]]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture
def group_of_one():
    """A gloo process group of this process alone, with LOCAL_RANK 1."""
    distributed.initialize(DistributedConfig(
        f"localhost:{_free_port()}", 1, 0, local_rank=1), device="cpu")
    try:
        yield
    finally:
        distributed.shutdown()


def test_get_device_under_a_group(group_of_one, monkeypatch):
    """Under a process group the default device is ``cuda:{LOCAL_RANK}``;
    it raises where that is not a visible device or there is no CUDA;
    the CPU stays the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert get_device() == torch.device("cuda", 1)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="LOCAL_RANK 1 is not a visible"):
        get_device()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_device()
    assert get_device("cpu") == torch.device("cpu")


def test_initialize_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = DistributedConfig(f"localhost:{_free_port()}", 1, 0, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        distributed.initialize(config)
    assert distributed.local_rank() is None
    assert distributed.process_count() == 1 and distributed.is_root()


def test_process_allgather_stacks_the_host_values(group_of_one):
    comm_stats.reset()
    got = distributed.process_allgather(np.arange(3.0))
    np.testing.assert_array_equal(got, np.arange(3.0)[None])
    assert comm_stats.snapshot() == {"all-gather": {"count": 1,
                                                    "bytes": 24}}


def test_a_data_parallel_mesh_is_no_spatial_mesh():
    """``spatial_parallel`` declares a mesh as ``ace_tpu``'s does;
    ``get_spatial_mesh`` is None for a data-parallel one, and after."""
    from ace_tpu_torch.parallel.mesh import get_spatial_mesh, spatial_parallel

    with spatial_parallel(MeshConfig(4).build(4, 1)) as mesh:
        assert (mesh.n_data, mesh.coord) == (4, 1)
        assert get_spatial_mesh() is None
    assert get_spatial_mesh() is None


def test_mean_counts_one_all_reduce_a_bucket(group_of_one):
    """Under a group of one the gradient mean is exact and counts one
    all-reduce a bucket with its bytes; the metrics' reduce one more."""
    placement = BatchPlacement(MeshConfig(1).build(), "cpu")
    grads = [torch.randn(5, 3), torch.randn(7), torch.randn(2, 2)]
    before = [g.clone() for g in grads]
    comm_stats.reset()
    placement.mean_(grads)
    assert all(torch.equal(g, b) for g, b in zip(grads, before))
    assert comm_stats.snapshot() == {
        "all-reduce": {"count": 1, "bytes": 4 * (15 + 7 + 4)}}
    assert comm_stats.format_comm_stats(comm_stats.snapshot()) == (
        "all-reduce:n=1,MB=0.00")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    return tmp, SyntheticData(tmp / "data", ALL_NAMES, n_time=6)


def test_a_mesh_of_one_without_a_group_is_no_mesh(data):
    """``mesh: {data_parallel: 1}`` in one process without a process
    group: the training entry's epoch (2 train steps, validation, inline
    inference) and the inference entry's windows bit for bit as without
    ``mesh``."""
    from ace_tpu_torch.inference.inference import main as infer
    from ace_tpu_torch.train.train import main as train

    tmp, synthetic = data
    ckpts, predictions = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "matplotlib", None)
        for name, mesh in (("none", None), ("one", {"data_parallel": 1})):
            config = sfno_config(tmp / name, synthetic, max_epochs=1)
            config["inference"] = {
                "loader": {"dataset": {"data_path": str(synthetic.data_dir)},
                           "start_indices": {"list": [0, 1]}},
                "n_forward_steps": 2, "forward_steps_in_memory": 1}
            if mesh is not None:
                config["mesh"] = mesh
            path = tmp / f"{name}.yaml"
            with open(path, "w") as f:
                yaml.safe_dump(config, f)
            train([str(path)], device="cpu")
            out = os.path.join(config["experiment_dir"],
                               "training_checkpoints")
            ckpts[name] = read_train_checkpoint(
                os.path.join(out, "ckpt.msgpack"))
            infer_config = {
                "experiment_dir": str(tmp / f"infer_{name}"),
                "checkpoint_path": os.path.join(out, "best_ckpt.msgpack"),
                "n_forward_steps": 2, "forward_steps_in_memory": 1,
                "logging": {"log_to_screen": False, "log_to_file": False},
                "forcing_loader": {
                    "dataset": {"data_path": str(synthetic.data_dir)},
                    "start_indices": {"list": [0, 1]}}}
            if mesh is not None:
                infer_config["mesh"] = mesh
            with open(tmp / f"infer_{name}.yaml", "w") as f:
                yaml.safe_dump(infer_config, f)
            predictions[name] = infer([str(tmp / f"infer_{name}.yaml")],
                                      device="cpu")["final_state"].data
    for key in ("params", "ema_state"):
        for k, v in ckpts["none"][key].items():
            assert torch.equal(ckpts["one"][key][k], v), (key, k)
    assert ckpts["one"]["extra"] == ckpts["none"]["extra"]
    for k, v in predictions["none"].items():
        assert torch.equal(predictions["one"][k], v), k
