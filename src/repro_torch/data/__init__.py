"""Prompt featurizer (the port's own copy of ``repro.data.featurizer``)."""
