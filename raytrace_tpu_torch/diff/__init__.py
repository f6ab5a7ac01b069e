from raytrace_tpu_torch.diff.render import (
    SceneParams,
    apply_params,
    extract_params,
    render_image_from_params,
)
