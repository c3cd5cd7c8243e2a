"""The worker's renderer build (``worker.renderer_build``: the scene
compiled to the device, the intersector's layouts, the lights, the camera)
per demo2 frame, in ms (``program_spans.span_ms``)."""

from benchmark.program_spans import RENDERER_BUILD, span_ms


def read(run):
    return span_ms(run, RENDERER_BUILD)
