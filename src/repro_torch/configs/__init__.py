"""The ten LM architecture configs (published numbers and reduced
miniatures), copies of ``repro.configs``; ``base`` is the registry."""
