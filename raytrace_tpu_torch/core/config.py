"""Typed render configuration (port of raytrace_tpu/core/config.py).

The same frozen dataclass, field for field and default for default; the JAX
module's comments explain each knob. Fields that select code paths this
port does not have (the hash-grid gather) are kept so configs move
between the two packages unchanged; the renderers raise NotImplementedError
where one differs from its default (renderers/common.py `require_forward`).
`ray_chunk` is read by no renderer of either package, `remat_walks` by no
render path of either (renderers/common.py). `use_bvh`, `intersect_rounds`
and `intersect_budget_scale` are read by no port path: JAX sizes its
engines' fixed-shape pair arrays by the last two, while the port's engines
run every pair of a launch (ops/intersect.py).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    # -- shared ---------------------------------------------------------
    width: int = 256
    height: int = 256
    spp: int = 1                      # samples per pixel (stratified)
    scene_epsilon: float = 0.1        # min-t for secondary rays
    shadow_epsilon: float = 1e-3      # shadow ray [eps, 1-eps] on unnormalized dir
    seed: int = 777                   # reference cuRAND default seed
    max_light_samples: int = 4        # static cap on per-light nSamples
    pixel_filter: str = "box"         # "box" | "triangle" | "gaussian"
    filter_radius: float = 0.0        # 0 = the filter's pbrt default

    # -- camera-pass specular chains -------------------------------------
    max_specular_depth: int = 10      # camera-ray specular bounce cap

    # -- photon tracing ---------------------------------------------------
    photon_paths: int = 512 * 512     # photon paths per progressive pass
    max_photon_depth: int = 4         # diffuse deposits per path (= slot count)
    max_photon_bounces: int = 10      # total walk iterations incl. specular
    russian_roulette: bool = True
    halton_stride_by_depth: bool = False
    photon_passes: int = 1            # progressive photon passes

    # -- progressive gathering --------------------------------------------
    initial_radius2: float = 4.0      # per-pixel starting search radius²
    ppm_alpha: float = 0.7            # Hachisuka radius-shrink alpha
    footprint_radius_scale: float = 0.0  # >0: SPPM footprint-seeded radii
    min_radius2: float = 1e-10        # floor for footprint-seeded radii

    # -- photon hash grid / gather capacity ----------------------------------
    grid_max_photons_per_cell: int = 32
    exact_gather: bool = False
    gather_rounds: int = 0            # 0 = derive from the photon-map size
    gather_r_max: int = 64            # per-tile (z, y)-row span budget
    gather_job_budget: int = 0        # per-round job capacity; 0 = 2^17

    # -- intersection -------------------------------------------------------
    use_bvh: bool = False
    ray_chunk: int = 0
    intersect_rounds: int = 1
    intersect_budget_scale: float = 1.0

    # -- wavefront compaction ----------------------------------------------
    wavefront_compact: bool = True
    compact_queue: int = 0            # queue width; 0 = auto (max(8192, n/8))
    compact_warm_steps: int = 0       # photon-walk full-width steps; 0 = auto

    # -- differentiation -----------------------------------------------------
    differentiable: bool = False
    remat_walks: bool = False

    @property
    def n_pixel_samples(self) -> int:
        return self.width * self.height * self.spp
