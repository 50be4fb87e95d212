"""The port's utilities: ``label_segments`` and the window and detection
helpers (:mod:`.utils`), tiling, the canopy seed and cost-surface workflow
(:mod:`.seeds`, :mod:`.cost`), image enhancement (:mod:`.image`) and the
detection tile preprocessor (:mod:`.training`). Pandas, sklearn and PIL are
imported inside functions, at the API edge."""
