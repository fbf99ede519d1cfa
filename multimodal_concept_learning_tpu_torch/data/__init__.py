"""Input path of the trainers: datasets, transforms, collation, batching (no Pillow)."""
