"""The port's vector layer: the pandas ``GeoDataFrame``, ``read_file`` and
``sjoin`` of :mod:`.geodataframe`, and the pandas-free tables of
:mod:`.features`. :mod:`.geodataframe` imports pandas, so its three names
are imported on first use and not with this package."""
__all__ = ["GeoDataFrame", "read_file", "sjoin"]


def __getattr__(name):
    if name in __all__:
        from . import geodataframe
        return getattr(geodataframe, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
