"""Design spaces: the candidate-type seam of the search stack.

:class:`DesignSpace` is what a search needs from a space; the paper's
schedule spaces (:class:`ScheduleSpace`) and parameter grids
(:class:`ParamSpace`, for tunable knobs like kernel block sizes) are
its instances, selected by name through :func:`make_space`.

The kernel parameter spaces (``flash_attention``, ``spmv_mulsum``,
``pack`` — :mod:`repro_torch.kernels.autotune`) are registered through
lazy factories: importing this package builds no kernel and allocates
nothing on a device.
"""
from repro_torch.space.base import (SPACES, DesignSpace, as_space,
                                    make_space, register_space)
from repro_torch.space.params import (KernelRunner, ParamFeature,
                                      ParamSpace, demo_param_space)
from repro_torch.space.schedule import (ScheduleSpace, canonical_key,
                                        eligible_items, random_schedule)

__all__ = [
    "DesignSpace", "ScheduleSpace", "ParamSpace", "ParamFeature",
    "KernelRunner", "SPACES", "register_space", "make_space",
    "as_space", "canonical_key", "eligible_items", "random_schedule",
    "demo_param_space",
]


def _schedule_factory(builder_name):
    def make(n_streams: int = 2, **kwargs) -> ScheduleSpace:
        from repro_torch.core import dag
        return ScheduleSpace(getattr(dag, builder_name)(**kwargs), n_streams)
    return make


def _kernel_factory(name):
    def make(**kwargs) -> ParamSpace:
        import repro_torch.kernels.autotune as autotune
        return getattr(autotune, name)(**kwargs)
    return make


# The paper's DAG schedule spaces.
register_space("spmv", _schedule_factory("spmv_dag"))
register_space("spmv_fine", _schedule_factory("spmv_dag_fine"))
register_space("halo3d", _schedule_factory("halo3d_dag"))
# The port's hand-written kernel grids (lazy: factories draw data and
# move it to the device).
register_space("flash_attention", _kernel_factory("flash_attention_space"))
register_space("spmv_mulsum", _kernel_factory("spmv_mulsum_space"))
register_space("pack", _kernel_factory("pack_space"))
# Analytic demo grid (tests, smoke runs).
register_space("demo", demo_param_space)
