"""The port's vector layer. :mod:`.geodataframe` imports pandas, so it is
imported on first use and not here."""
