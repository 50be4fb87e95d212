"""Command-line interface (port of ``obia_tpu/cli.py``): ``segment``,
``tiled-segments``, ``chm-seeds``, ``density-seeds``, ``canonical-seeds``,
``cost-surface``, ``bench`` (:mod:`obia_tpu_torch.bench`, in this process)
and ``info``, runnable as ``obia-tpu-torch <command>``.

``click`` is imported by :func:`build_cli`, not with the module, so the
module imports where click is not installed. Every command but ``info``
runs on the card unless given ``--device cpu``.
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

    @main.command("chm-seeds")
    @click.argument("chm", type=click.Path(exists=True))
    @click.argument("out_gpkg", type=click.Path())
    @click.option("--h-min", default=2.5, show_default=True)
    @click.option("--min-dist-px", default=3, show_default=True)
    @click.option("--sigma", default=1.0, show_default=True)
    @click.option("--device", default=None,
                  help="torch device (default: the card)")
    def chm_seeds_cmd(chm, out_gpkg, h_min, min_dist_px, sigma, device):
        """Canopy-height-model peak seeds."""
        from .utils.seeds import make_chm_seeds
        make_chm_seeds(chm, out_gpkg, h_min_m=h_min, min_dist_px=min_dist_px,
                       gauss_sigma=sigma, device=device)

    @main.command("density-seeds")
    @click.argument("density", type=click.Path(exists=True))
    @click.argument("out_gpkg", type=click.Path())
    @click.option("--d-min", default=4.5, show_default=True)
    @click.option("--min-dist-px", default=4, show_default=True)
    @click.option("--sigma", default=2.0, show_default=True)
    @click.option("--device", default=None,
                  help="torch device (default: the card)")
    def density_seeds_cmd(density, out_gpkg, d_min, min_dist_px, sigma,
                          device):
        """Density-raster peak seeds."""
        from .utils.seeds import make_density_seeds
        make_density_seeds(density, out_gpkg, d_min=d_min,
                           min_dist_px=min_dist_px, gauss_sigma=sigma,
                           device=device)

    @main.command("canonical-seeds")
    @click.argument("chm_seeds", type=click.Path(exists=True))
    @click.argument("den_seeds", type=click.Path(exists=True))
    @click.argument("chm", type=click.Path(exists=True))
    @click.argument("cost_surface", type=click.Path(exists=True))
    @click.argument("out_gpkg", type=click.Path())
    @click.option("--merge-radius", default=1.5, show_default=True)
    @click.option("--cost-weight", default=0.5, show_default=True)
    @click.option("--device", default=None,
                  help="torch device (default: the card)")
    def canonical_seeds_cmd(chm_seeds, den_seeds, chm, cost_surface,
                            out_gpkg, merge_radius, cost_weight, device):
        """Merge CHM + density seeds into canonical seed points."""
        from .utils.seeds import make_canonical_seeds
        make_canonical_seeds(chm_seeds, den_seeds, chm, cost_surface,
                             out_gpkg, merge_radius=merge_radius,
                             cost_weight=cost_weight, device=device)

    @main.command("cost-surface")
    @click.argument("wv3", type=click.Path(exists=True))
    @click.argument("chm", type=click.Path(exists=True))
    @click.argument("out", type=click.Path())
    @click.option("--slic", default=None, type=click.Path(exists=True))
    @click.option("--weights", default="0.5,0.25,0.25,0", show_default=True)
    @click.option("--device", default=None,
                  help="torch device (default: the card)")
    def cost_cmd(wv3, chm, out, slic, weights, device):
        """Weighted cost surface from CHM gradient + NDVI gap + entropy."""
        from .utils.cost import make_cost_surface
        w = tuple(float(x) for x in weights.split(","))
        make_cost_surface(wv3, chm, out, slic=slic, weights=w, device=device)

    @main.command("bench")
    @click.option("--size", default=2048, show_default=True)
    @click.option("--config", default=None, type=click.IntRange(1, 5),
                  help="one configuration (default: the sweep)")
    @click.option("--forest", default="stand-in", show_default=True,
                  type=click.Choice(["stand-in", "fit"]),
                  help="configs 1 and 4's forest")
    @click.option("--device", default=None,
                  help="torch device (default: the card)")
    def bench_cmd(size, config, forest, device):
        """End-to-end throughput benchmark (one JSON line)."""
        from . import bench
        try:
            bench.run(size, config, forest, device)
        except bench.SweepFailed as exc:
            raise click.ClickException(str(exc))

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
