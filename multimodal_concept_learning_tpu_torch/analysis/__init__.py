"""Analysis CLIs of the port (counterparts of multimodal_concept_learning_tpu/analysis/),
in numpy alone: plots need matplotlib (and plotly for the 3D page) and are
skipped without them; every number is still printed."""
