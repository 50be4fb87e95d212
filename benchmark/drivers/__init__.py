"""One driver per kind of work, found by a configuration's ``driver``."""
