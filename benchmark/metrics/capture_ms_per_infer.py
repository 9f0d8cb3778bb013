"""``autotune.ladder`` layer: milliseconds of CUDA-graph capture an
inference, the registry's ``xla_compile_seconds_total`` over the window
over the inferences (each inference's fresh sampler captures anew)."""


def read(ctx: dict):
    n = ctx["inferences"]
    d = ctx["registry_delta"].get("xla_compile_seconds_total")
    if not n or not d:
        return None
    return 1e3 * d / n
