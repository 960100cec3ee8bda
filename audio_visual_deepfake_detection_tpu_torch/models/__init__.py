from .meta_arch import AVLocalizer, build_localizer, init_localizer  # noqa: F401
