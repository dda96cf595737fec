"""Raw array I/O: file formats, catalog, and synthetic dataset generators."""
from repro_torch.arrayio.formats import (FORMATS, read_array_file,
                                   write_array_file)
from repro_torch.arrayio.catalog import Catalog, FileReader, build_catalog
from repro_torch.arrayio.generator import (GeneratedFile, make_geo_files,
                                     make_ptf_files)

__all__ = ["FORMATS", "read_array_file", "write_array_file", "Catalog",
           "FileReader", "build_catalog", "GeneratedFile", "make_geo_files",
           "make_ptf_files"]
