"""Port utilities: the codec config and seeded test inputs. Errors come from the reference."""
