"""The stencil DSL and its encodings on PyTorch: specs, boundary handling,
the shifted-add oracle, the paper's conv and dense encodings, the dispatcher
(``plan.py``) and the run-to-convergence solver (``solver.py``).

``stencil_apply(spec, x, backend="auto", ...)`` routes one ``StencilSpec``
through any backend (reference oracle, dense, conv, native Conv3D, direct
CUDA kernels, temporally-fused CUDA kernel); ``make_plan`` prepares a
reusable executor and ``backend_support`` reports which backends are legal
for a cell.
``solve``/``Solver`` run the Jacobi time loop to convergence;
``autotune.py`` measures schedules into the tuned table ``auto`` consults
first; ``multigrid.py`` composes the plans into a geometric-multigrid
V-cycle; ``plan_cache.py`` is the serving tier's bucketed cache of built
solvers (``serve/engine.py`` coalesces requests over it);
``adjoint.py``'s ``implicit_solve`` is the differentiable solve (its
backward is one solve with the transposed operator).  Entry points run on
the card unless given ``device="cpu"`` (the adjoint: a CPU default cache).
"""
from repro_torch.core.adjoint import (
    DIFF_BACKENDS,
    implicit_solve,
    transpose_fields,
    transpose_spec,
)
from repro_torch.core.autotune import (
    TunedEntry,
    TunedTable,
    autotune_cell,
    default_tuned_table,
    set_default_tuned_table,
    shape_bucket,
    spec_family,
)
from repro_torch.core.boundary import BoundaryMode, DirichletBC, runtime_bc_grids
from repro_torch.core.conv1d import causal_conv1d, causal_conv1d_update
from repro_torch.core.conv_encoding import (
    conv2d_apply,
    conv2d_kernel,
    conv3d_channels_kernel,
    conv3d_kernel,
    conv_jacobi_2d,
    conv_jacobi_3d_channels,
    conv_jacobi_3d_native,
    conv_var_jacobi,
    split_var_kernels,
)
from repro_torch.core.dense_encoding import (
    build_dense_matrix,
    dense_jacobi,
    dense_jacobi_with_bc,
    dense_layer_bytes,
    var_tap_indices,
)
from repro_torch.core.metrics import DeliveredPerf, encoding_flops_per_point
from repro_torch.core.multigrid import (
    MGResult,
    Multigrid,
    coarse_shape,
    coarsen_spec,
    multigrid_solve,
    prolongation_spec,
    red_black_step,
    restriction_spec,
)
from repro_torch.core.plan_cache import (
    CachedSolver,
    CacheStats,
    PlanCache,
    default_plan_cache,
    set_default_plan_cache,
)
from repro_torch.core.plan import (
    BACKENDS,
    DEVICE_PROFILES,
    BackendSupport,
    DeviceProfile,
    StencilPlan,
    backend_support,
    choose_backend,
    estimate_seconds,
    make_plan,
    stencil_apply,
)
from repro_torch.core.reference import apply_stencil, jacobi_reference, jacobi_step
from repro_torch.core.solver import SolveResult, Solver, select_fuse, solve
from repro_torch.core.stencil import (
    StencilSpec,
    WeightField,
    box,
    causal_conv1d_spec,
    heterogeneous_jacobi,
    laplace_jacobi,
    spec_from_taps,
    star,
    variable_coefficient,
)

__all__ = [
    "BACKENDS",
    "BackendSupport",
    "BoundaryMode",
    "CachedSolver",
    "CacheStats",
    "DeliveredPerf",
    "DEVICE_PROFILES",
    "DIFF_BACKENDS",
    "DeviceProfile",
    "DirichletBC",
    "MGResult",
    "Multigrid",
    "PlanCache",
    "Solver",
    "SolveResult",
    "StencilPlan",
    "StencilSpec",
    "TunedEntry",
    "TunedTable",
    "WeightField",
    "apply_stencil",
    "autotune_cell",
    "backend_support",
    "box",
    "build_dense_matrix",
    "causal_conv1d",
    "causal_conv1d_spec",
    "causal_conv1d_update",
    "choose_backend",
    "coarse_shape",
    "coarsen_spec",
    "conv2d_apply",
    "conv2d_kernel",
    "conv3d_channels_kernel",
    "conv3d_kernel",
    "conv_jacobi_2d",
    "conv_jacobi_3d_channels",
    "conv_jacobi_3d_native",
    "conv_var_jacobi",
    "default_plan_cache",
    "default_tuned_table",
    "dense_jacobi",
    "dense_jacobi_with_bc",
    "dense_layer_bytes",
    "encoding_flops_per_point",
    "estimate_seconds",
    "heterogeneous_jacobi",
    "implicit_solve",
    "jacobi_reference",
    "jacobi_step",
    "laplace_jacobi",
    "make_plan",
    "multigrid_solve",
    "prolongation_spec",
    "red_black_step",
    "restriction_spec",
    "runtime_bc_grids",
    "select_fuse",
    "set_default_plan_cache",
    "set_default_tuned_table",
    "shape_bucket",
    "solve",
    "spec_family",
    "spec_from_taps",
    "split_var_kernels",
    "star",
    "stencil_apply",
    "transpose_fields",
    "transpose_spec",
    "var_tap_indices",
    "variable_coefficient",
]
