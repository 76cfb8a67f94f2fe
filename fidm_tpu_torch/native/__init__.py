"""Host C++ helpers of the data path (the port's copies of `fidm_tpu/native`):
`maskgen.cpp` (procedural masks, fused normalize/compose) and `imgload.cpp`
(libjpeg/libpng decode with a Pillow-exact resize), built with g++ at first
use and bound with ctypes (`build.py`, `imgload.py`)."""
