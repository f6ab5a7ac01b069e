from raytrace_tpu_torch.parallel.sharded import (
    make_mesh,
    render_photon_sharded,
    train_step_sharded,
)
