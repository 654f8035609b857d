"""Partition specs (`rules`), placements (`placement`) and the collectives
(`collectives`) of sharded training and of the compute split over the
mesh's ``model`` axis. The package imports none of them itself: the model's
layers import `collectives`, which the rules' own imports of the model
would otherwise make circular."""
