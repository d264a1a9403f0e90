from rsoderh_raytracing_tpu_torch.scene.device import (  # noqa: F401
    DeviceScene,
    build_device_scene,
    device_scene_from_arrays,
)
