"""Configurations: one JSON file of sizes and one generator module per
scene, found by name (`<name>.json`, `<name>.py` with `build(cfg)`)."""
