from .inverse import (
    FitResult,
    coarse_emitter_search,
    emitter_grid,
    fit_scene_parameters,
    ir_loss,
    material_ids_padded,
    render_soft_ir,
    smooth_ir,
    with_material_absorption,
)
from .replay import record_paths, render_ir_replay, replay_events

__all__ = [
    "FitResult", "coarse_emitter_search", "emitter_grid",
    "fit_scene_parameters", "ir_loss", "material_ids_padded",
    "record_paths", "render_ir_replay",
    "render_soft_ir", "replay_events",
    "smooth_ir", "with_material_absorption",
]
