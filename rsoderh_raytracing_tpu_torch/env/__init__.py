from rsoderh_raytracing_tpu_torch.env.environment import (  # noqa: F401
    DeviceEnvironment,
    Environment,
    EnvironmentMaps,
    device_environment,
    device_environment_from_arrays,
    load_default_environments,
)
