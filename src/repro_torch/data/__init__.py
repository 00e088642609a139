"""The port's data pipeline: the reference's synthetic token stream."""
