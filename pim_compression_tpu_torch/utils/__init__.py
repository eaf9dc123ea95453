"""Port utilities: the codec config, typed errors and seeded test inputs."""
