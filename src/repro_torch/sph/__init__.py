"""``repro_torch.sph`` — the user-facing SPH scenario entry point.

Port of ``repro.sph``. Re-exports the scenario API (cases registry,
Simulation facade, physics schemes, boundary builders) and hosts the CLI
(on CUDA unless ``--device`` names another):

    python -m repro_torch.sph list
    python -m repro_torch.sph run taylor_green --nsteps 600 --observe-every 20
    python -m repro_torch.sph run dam_break --n 2000 --backend xla
    python -m repro_torch.sph run dam_break --json          # machine-readable
    python -m repro_torch.sph sweep poiseuille --batch 8 --checkpoint ckpt/
    python -m repro_torch.sph serve dam_break --checkpoint ck/   # online service
    python -m repro_torch.sph request dam_break --observe

See ``repro_torch/sph/__main__.py`` for the command surface. The serving
layer (``SimServer``, ``LaneEngine``, the frame protocol) lives in
``repro_torch/sph/serve.py`` + ``repro_torch/sph/client.py``.
"""
from repro_torch.core.api import Observables, SimResult, Simulation  # noqa: F401
from repro_torch.core.boundaries import (  # noqa: F401
    FLUID,
    WALL,
    box_wall_particles,
    fluid_lattice,
)
from repro_torch.core.cases import (  # noqa: F401
    CASES,
    CaseSpec,
    build_case,
    case_names,
    register_case,
    resolve_ds,
)
from repro_torch.core.ensemble import (  # noqa: F401
    AdmissionError,
    EngineFull,
    EnsembleReport,
    FaultBusy,
    LaneEngine,
    LaneEvent,
    MemberReport,
    SweepRequest,
    SweepResult,
    member_config,
    run_ensemble,
    run_sweep,
)
from repro_torch.core.health import FaultSpec, SimulationDiverged  # noqa: F401
from repro_torch.core.recovery import (  # noqa: F401
    GuardPolicy,
    GuardReport,
    run_guarded,
)
from repro_torch.core.scheme import Scheme, wcsph  # noqa: F401
