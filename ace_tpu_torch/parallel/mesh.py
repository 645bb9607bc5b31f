"""The (data, h, w) process mesh (port of ace_tpu/parallel/mesh.py).

``ace_tpu`` lays a ``jax.sharding.Mesh`` over its devices and lets XLA's
SPMD partitioner place the collectives. The port runs one process per
GPU, so its mesh is a shape over the ranks of ``torch.distributed`` and
this rank's place in it; the collectives are explicit calls of
``parallel/distributed.py``. Only the data axis is ported: a mesh with
``h * w > 1`` (spatial parallelism, the distributed SHT and DISCO) is
refused until ROADMAP Queue 1 item 5b ports it.

``ace_tpu``'s ``batch_spec``, ``shard_batch``, ``replicated`` and
``use_mesh`` place arrays for the SPMD partitioner; their counterpart is
the row slicing of ``distributed.BatchPlacement``. ``parameter_spec`` and
``shard_parameters`` (FSDP) have no caller in ``ace_tpu``'s entries and
are not ported.
"""

import contextlib
import dataclasses


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A data-parallel mesh of ranks: its size along the data axis and
    this rank's coordinate on it."""

    n_data: int
    coord: int


@dataclasses.dataclass
class MeshConfig:
    """The mesh's shape (port of ace_tpu/parallel/mesh.py:30; the fields of
    ``mesh:`` in the entries' configs). ``data_parallel = -1`` means every
    rank."""

    data_parallel: int = -1
    h: int = 1
    w: int = 1

    def __post_init__(self):
        if self.h * self.w > 1:
            raise NotImplementedError(
                f"mesh: h={self.h}, w={self.w}: spatial parallelism is not "
                "ported yet (ROADMAP Queue 1 item 5b); the port runs a "
                "data-parallel mesh (h = w = 1)"
            )

    def build(self, world_size: int | None = None,
              rank: int | None = None) -> Mesh:
        """The mesh over ``world_size`` ranks (by default the process
        group's) with ``rank``'s coordinate (by default this process's).
        Raises ``ace_tpu``'s error on the same counts (its other error,
        a count that h * w does not divide, needs a spatial mesh)."""
        from ace_tpu_torch.parallel import distributed

        n = distributed.process_count() if world_size is None else world_size
        rank = distributed.process_index() if rank is None else rank
        data = self.data_parallel if self.data_parallel > 0 else n
        if data != n:
            raise ValueError(f"mesh ({data}, 1, 1) != {n} devices")
        return Mesh(data, rank)


_SPATIAL_MESH: Mesh | None = None


# spatial_parallel and get_spatial_mesh have no caller in the port until
# ROADMAP Queue 1 item 5b: the entries enter no spatial mesh
@contextlib.contextmanager
def spatial_parallel(mesh: Mesh | None):
    """Declare the active mesh for spatial model parallelism, as
    ``ace_tpu``'s does."""
    global _SPATIAL_MESH
    old = _SPATIAL_MESH
    _SPATIAL_MESH = mesh
    try:
        yield mesh
    finally:
        _SPATIAL_MESH = old


def get_spatial_mesh() -> Mesh | None:
    """The mesh declared via ``spatial_parallel`` if it decomposes space;
    the port's meshes are data-parallel only, so always None."""
    return None
