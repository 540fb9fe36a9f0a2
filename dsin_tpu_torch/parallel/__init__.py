"""Training over more than one device with `torch.distributed`: the
(data, spatial) mesh (`mesh.py`), the width-sharded patch search
(`spatial.py`) and the data-parallel and width-sharded steps
(`data_parallel.py`); `launch.py` spawns the ranks of one host."""
