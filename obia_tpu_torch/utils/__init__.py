"""The port's utilities: ``label_segments`` and the window and detection
helpers (:mod:`.utils`), tiling, the canopy seed and cost-surface workflow
(:mod:`.seeds`, :mod:`.cost`) and image enhancement (:mod:`.image`).
Pandas and sklearn are imported inside functions, at the API edge."""
