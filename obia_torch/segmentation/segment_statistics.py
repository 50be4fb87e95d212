import importlib as _importlib
import sys as _sys

# the module itself: a package attribute of the same name may be a function
_impl = _importlib.import_module("obia_tpu_torch.segmentation.segment_statistics")
# expose everything, underscore names included, as the reference path does
for _n in dir(_impl):
    if not _n.startswith("__"):
        setattr(_sys.modules[__name__], _n, getattr(_impl, _n))
