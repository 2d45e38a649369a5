"""The C++ image loader (cxr_loader.cpp) and its Python route."""
