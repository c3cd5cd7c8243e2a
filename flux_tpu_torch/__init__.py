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
``meshgen.py`` generate sphere fields and meshes.

Entry points (``Renderer``, ``cli``) run on the CUDA card unless the caller
asks for the CPU (``device="cpu"``), where the plain PyTorch version of the
kernel runs instead. This package imports neither JAX nor ``flux_tpu``.
"""

__version__ = "0.1.0"
