"""What the benchmark measures against: peaks, kernel buckets, the
conv's own work, and the reading of a profiler trace."""
