"""The inlier share of ORB's good matches: 100 x the port's orb.inliers
over orb.good (the RANSAC inliers and the valid best pairs of each
result), counted in the port's span table over the traced window."""
from fipm_bench.program import counter_pct


def read(rec):
    return counter_pct(rec, "orb.inliers", "orb.good")
