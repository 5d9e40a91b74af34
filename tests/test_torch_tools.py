"""What the CPU can check of the port's tools (codec_tpu_torch/tools), which
run only on the card: that no function loads a global name its module
leaves unbound (such a name fails only when the function runs), and that
`profile_decode mimi_stream` gets past its preamble to its model.
"""

import pytest
import torch

TOOL_MODULES = ["ab_requests", "compare_sass", "f16_probe", "mimi_times",
                "profile_decode", "qmat_plans", "roofline", "rvq_phases",
                "sass_report", "seanet_times"]


def _global_loads(code):
    """The global names a code object (and those nested in it) loads."""
    import dis

    names = {i.argval for i in dis.get_instructions(code)
             if i.opname in ("LOAD_GLOBAL", "LOAD_NAME")}
    for const in code.co_consts:
        if hasattr(const, "co_code"):
            names |= _global_loads(const)
    return names


@pytest.mark.parametrize("name", TOOL_MODULES)
def test_tool_functions_load_only_bound_globals(name):
    """Each function of a tool (they run only on the card) loads no global
    name its module leaves unbound: such a name fails only when the
    function runs."""
    import builtins
    import importlib
    import inspect

    mod = importlib.import_module(f"codec_tpu_torch.tools.{name}")
    free = {}
    for fname, fn in inspect.getmembers(mod, inspect.isfunction):
        if fn.__module__ != mod.__name__:
            continue
        missing = {n for n in _global_loads(fn.__code__)
                   if n not in vars(mod) and not hasattr(builtins, n)}
        if missing:
            free[fname] = sorted(missing)
    assert not free, free


def test_profile_tool_mimi_stream_gets_to_its_model(monkeypatch):
    """`profile_decode mimi_stream` goes past its preamble to writing its
    model (stopped there: the rest needs the card)."""
    from codec_tpu_torch.models import mimi_init as mi
    from codec_tpu_torch.tools import profile_decode

    class Reached(Exception):
        pass

    def stop(*a, **k):
        raise Reached

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(profile_decode, "_card", lambda: "test card")
    monkeypatch.setattr(mi, "write_random_mimi_gguf", stop)
    with pytest.raises(Reached):
        profile_decode.main(["mimi_stream"])
