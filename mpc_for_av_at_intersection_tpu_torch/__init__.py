"""PyTorch / CUDA port of ``mpc_for_av_at_intersection_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference; each module here names the
module it ports. Layout mirrors it:

- ``core``     — plant dynamics, angle utilities, course localization
- ``models``   — vehicle geometry
- ``worlds``   — junction generators -> padded half-plane arrays
- ``lattice``  — motion primitives, the host search, and the device planner
                 (serial-A* and beam engines)
- ``native``   — the C++ host search, built from its own source with g++
- ``agents``   — scripted agents, prediction, conflict scan
- ``mpc``      — the batched controller tick (``mpc_step_batched``) and its
                 plain pieces: reference, linearization, condensing, ADMM solver
- ``engine``   — the single-scenario closed loop (``run_episode``), the
                 fleet engine and the multi-ego engine
- ``ops``      — hand-written CUDA kernels (sources in ``csrc/``) with their
                 wrappers: K1 ``condense_qp``, K2 ``admm``, K3 ``astar``,
                 K4 ``collision``
- ``api``      — course planning, the scenario drivers (``build_intersection``
                 and the six others) and the Monte-Carlo fleet builders; the
                 planning and fleet entry points are also reachable here
                 (``plan_course``, ``plan_courses_batch``,
                 ``sample_intersection_fleet``, ``sample_intersection_fleet_batched``,
                 ``sample_intersection_fleet_geom``)
- ``engine.run_episode_live`` — the per-tick host loop behind live rendering
- ``parallel`` — batch runs, on one device or sharded over the ranks of a
                 ``torch.distributed`` mesh (``distributed``, ``fleet_worker``)
- ``sweep``    — MPC-weight and planner-weight sensitivity sweeps
- ``utils``    — plotting and ``LiveView``, checkpoint / resume, the grid-A*
                 demo, timing helpers
- ``cli``      — ``python -m mpc_for_av_at_intersection_tpu_torch
                 run|plan|fleet|sweep|bench`` (``--device cpu`` off the card);
                 ``bench`` the headline benchmark

Tensors on a CUDA device run the kernels; CPU tensors run the plain PyTorch
versions. Nothing here imports JAX.
"""

__version__ = "0.1.0"

_API = ("plan_course", "plan_courses_batch", "sample_intersection_fleet",
        "sample_intersection_fleet_batched", "sample_intersection_fleet_geom")


def __getattr__(name):
    """The ``api`` entry points, imported on first use."""
    if name in _API:
        from . import api

        return getattr(api, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
