from omega_tpu_torch.io.netcdf import NCFile, read_netcdf, write_netcdf
from omega_tpu_torch.io.stream import IOStream, StreamManager, StreamSpec
