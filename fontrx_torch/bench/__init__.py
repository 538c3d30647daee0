"""The port's benchmark inputs."""
