"""flux_tpu_torch — the flux path tracer on PyTorch and CUDA.

The second implementation of the path tracer beside ``flux_tpu`` (JAX on a
TPU), which stays the reference it is tested against. Module names mirror
``flux_tpu``'s so that each module's counterpart is found by name; inside,
the code is plain PyTorch on tensors with an explicit ``device``. The
hot-path kernels are CUDA C++ written for Hopper: the sweep megakernel
(``csrc/sweep_megakernel.cu``, bound in ``ops/sweep_kernel.py``) for scenes
of at most 64 spheres, and the scene megakernel
(``csrc/scene_megakernel.cu``, bound in ``ops/scene_kernel.py``) for the
scan over sphere tables of any size, triangle meshes and triangle lights;
both share one path tracer (``csrc/flux_trace.cuh``) and have one template
instantiation for each estimator configuration (reference transport, the
stats channel, NEE, physical transport and MIS). Progressive, adaptive and
checkpointed renders are in ``checkpoint.py``; ``genscene.py`` and
``meshgen.py`` generate sphere fields and meshes. A CLI render is a job
(``job.py``) that a ``RenderManager`` (``manager.py``, with the scheduler
round of ``sched.py``) hands out in row bands to a local worker and to
render nodes (``workers.py``, ``node.py``, ``wire.py``), whose frames are
``flux_tpu``'s; the PPM encoder is native host code (``csrc/fluxnative.cpp``).
Several devices, or processes, render one job over a device mesh
(``parallel/``); ``sampler_debug.py`` plots the sample grids
(``samplers/grids.py``).

Entry points (``Renderer``, ``cli``) run on the CUDA card unless the caller
asks for the CPU (``device="cpu"``), where the plain PyTorch version of the
kernel runs instead. This package imports neither JAX nor ``flux_tpu``.
"""

__version__ = "0.1.0"

# flux_tpu's package-level names, each resolved at first use (PEP 562), so
# that importing the package, or one module of it such as the float64
# oracle, loads none of the renderer, the samplers or the kernels' wrappers.
_NAMES = {
    "constants": ("constants", None),
    "samplers": ("samplers", None),
    "Job": ("job", "Job"),
    "JobConfiguration": ("job", "JobConfiguration"),
    "JobID": ("job", "JobID"),
    "WorkUnit": ("job", "WorkUnit"),
    "Renderer": ("render", "Renderer"),
    "SceneData": ("scene", "SceneData"),
    "compile_scene": ("scene", "compile_scene"),
    "load_scene": ("scene", "load_scene"),
    "loads_scene": ("scene", "loads_scene"),
    "manager": ("manager", None),
    "workers": ("workers", None),
    "node": ("node", None),
    "parallel": ("parallel", None),
    "image": ("image", None),
    "cli": ("cli", None),
}

__all__ = list(_NAMES)


def __getattr__(name):
    if name not in _NAMES:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    module, attr = _NAMES[name]
    mod = importlib.import_module(f".{module}", __name__)
    return mod if attr is None else getattr(mod, attr)
