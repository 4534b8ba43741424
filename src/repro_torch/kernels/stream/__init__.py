"""The streaming baselines' scans: HDRF and Oblivious, one edge a step."""
