"""The benchmark's yardstick: manifest resolution, traffic, weights, the
device trace and its reduction, peaks, and the import guard. Nothing here
imports the measured program at module level."""
