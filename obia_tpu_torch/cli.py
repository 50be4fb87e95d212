"""Command-line interface (port of ``obia_tpu/cli.py``): ``segment``,
``tiled-segments`` and ``info``, runnable as ``obia-tpu-torch <command>``.

``click`` is imported by :func:`build_cli`, not with the module, so the
module imports where click is not installed. ``segment`` and
``tiled-segments`` run on the card unless given ``--device cpu``.
"""
from __future__ import annotations

import json


def build_cli():
    """The click command group."""
    import click

    @click.group()
    def main():
        """obia-tpu-torch: object-based image analysis in PyTorch and CUDA."""

    @main.command("segment")
    @click.argument("raster", type=click.Path(exists=True))
    @click.argument("out_gpkg", type=click.Path())
    @click.option("--method", default="slic",
                  type=click.Choice(["slic", "quickshift"]))
    @click.option("--n-segments", default=3000, show_default=True)
    @click.option("--compactness", default=10.0, show_default=True)
    @click.option("--kernel-size", default=5.0, show_default=True)
    @click.option("--max-dist", default=10.0, show_default=True)
    @click.option("--bands", default=None,
                  help="comma-separated 0-based segmentation band indices")
    @click.option("--device", default=None,
                  help="torch device (default: the card)")
    def segment_cmd(raster, out_gpkg, method, n_segments, compactness,
                    kernel_size, max_dist, bands, device):
        """Segment RASTER and write objects + features to OUT_GPKG."""
        from .handlers.geotif import open_geotiff
        from .segmentation.segment import segment

        image = open_geotiff(raster)
        seg_bands = ([int(b) for b in bands.split(",")] if bands else None)
        kwargs = ({"n_segments": n_segments, "compactness": compactness}
                  if method == "slic"
                  else {"kernel_size": kernel_size, "max_dist": max_dist})
        s = segment(image, segmentation_bands=seg_bands, method=method,
                    device=device, **kwargs)
        s.write_segments(out_gpkg)
        click.echo(f"wrote {len(s.table):,} objects -> {out_gpkg}")

    @main.command("tiled-segments")
    @click.argument("raster", type=click.Path(exists=True))
    @click.argument("output_dir", type=click.Path())
    @click.option("--mask", default=None, type=click.Path(exists=True))
    @click.option("--tile-size", default=200, show_default=True)
    @click.option("--buffer", default=30, show_default=True)
    @click.option("--crown-radius", default=5.0, show_default=True)
    @click.option("--n-segments", default=None, type=int)
    @click.option("--resume/--no-resume", default=False)
    @click.option("--device", default=None,
                  help="torch device (default: the card)")
    def tiled_cmd(raster, output_dir, mask, tile_size, buffer, crown_radius,
                  n_segments, resume, device):
        """Checkerboard tiled segmentation with seam handling."""
        from .utils.tiling import create_tiled_segments

        kwargs = {"n_segments": n_segments} if n_segments else {}
        out = create_tiled_segments(raster, output_dir, input_mask=mask,
                                    tile_size=tile_size, buffer=buffer,
                                    crown_radius=crown_radius, resume=resume,
                                    device=device, **kwargs)
        click.echo(f"wrote {len(out):,} segments -> "
                   f"{output_dir}/segments.gpkg")

    @main.command("info")
    def info_cmd():
        """Device and native-library status."""
        import torch

        from . import _build, native
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        click.echo(json.dumps({
            "cuda": torch.cuda.is_available(),
            "devices": [torch.cuda.get_device_name(i) for i in range(count)],
            "count": count,
            "native_library": native.library_path().exists(),
            "kernel_library": _build.library_path().exists(),
        }, indent=1))

    return main


def main(args=None):
    """Entry point of the ``obia-tpu-torch`` script."""
    return build_cli()(args)


if __name__ == "__main__":
    main()
