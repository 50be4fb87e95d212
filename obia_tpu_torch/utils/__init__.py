"""The port's utilities (``label_segments``). :mod:`.utils` imports pandas
inside its functions, at the API edge."""
