from .params import RenderSettings, StaticConfig
